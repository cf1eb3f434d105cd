"""`batched.py`'s request, run unchanged; in a traced run (its spans end
on a device synchronize) inside the program's own span and counter
recorder, `rssync_tpu_torch.utils.timing.recording(context=<request
index>)`, which stays on the request as `req.recorder` for the readers
of `metrics/program.py`. Untraced, nothing is recorded and the request
does the work of `batched.py`'s."""

import importlib.util
from pathlib import Path


def _load_batched():
    path = Path(__file__).with_name("batched.py")
    spec = importlib.util.spec_from_file_location("portbench_request_batched", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_BATCHED = _load_batched()


def run(d, req, spans):
    if not spans.sync:
        return _BATCHED.run(d, req, spans)
    from rssync_tpu_torch.utils.timing import recording

    with recording(context=req.index) as rec:
        req.recorder = rec
        return _BATCHED.run(d, req, spans)
