"""What a window extraction's time is made of: port of
experiments/mb_extract2.py (kernel E4), on mb_extract.py's image as
float32 (2028 x 2704 from numpy seed 0), REPS = 50 calls at origins
(o + i) % 1500, each call's output summed in float64. Variants (the
experiment's label in brackets):

  floor                a static 40 x 40 slice + a scalar from the
                       origins, summed [floor: static slice + sum]
  gather_n{N}_s40      dynamic_slice's clamp + one advanced-index gather,
                       N in 8, 32, 130, 256 [vmap(dynslice) f32 N=.. S=40]
  gather_n130_s{S}     the same at N = 130, S in 8, 16, 64, 128
  seq                  130 `narrow` + sum, one after another, origins on
                       the host [fori_loop 130 sequential dynslice]: a
                       launch per window, as the scan paid a dispatch
  kernel_nbuf{2,8,16}  E4's clamp (rows 48, cols 168), origins padded to
                       Npad = 130, the port's kernel with nbuf patches a
                       block [pallas burst nbuf=..]

Every origin set draws from one seed, as the experiment's from one key,
so gather_n130_s40, seq and the three kernels extract the same pixels
and their sums agree bit for bit. Each kernel row also carries E4's own
check: patches 0, 64 and 129 equal a direct slice of the image.

    python -m rssync_tpu_torch.experiments.mb_extract2 [variants]
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from rssync_tpu_torch.experiments._harness import (
    card_line,
    main_on_card,
    per_call,
    rep_line,
    select,
    timed,
)
from rssync_tpu_torch.experiments.mb_extract import (
    Shape,
    kernel_body,
    make_image,
    make_origins,
    repeat,
    shape,
)
from rssync_tpu_torch.ops.patches import clamp_slice, extract_patches_ref

#: (window counts at the main size, sizes at the main count) of the sweeps
SWEEPS = {False: ((8, 32, 130, 256), (8, 16, 64, 128)), True: ((2, 4, 6, 12), (2, 4, 12, 16))}
NBUF = (2, 8, 16)
#: E4's row alignment: the float32 sublane tile
SUB = 8


def kernel_call(img: torch.Tensor, p: Shape, nbuf: int):
    """E4's call: its clamp, the origins padded with zeros to Npad (one
    chunk of all the points, so Npad = N), the kernel with `nbuf`
    patches a block."""
    chunk = p.points
    npad = -(-p.points // chunk) * chunk
    clamped = kernel_body(img, p.size, SUB, patches_per_block=nbuf)

    def body(o):
        return clamped(F.pad(o, (0, 0, 0, npad - o.shape[0])))

    return body


def cases(img: torch.Tensor, p: Shape, small: bool) -> dict:
    """{name: (call, (N, size) of the windows it extracts or None)}."""
    H, W = img.shape
    dev = img.device
    S, N = p.size, p.points
    o_main = make_origins(dev, N, small)

    def gather(s):
        return lambda o: extract_patches_ref(img, clamp_slice(o, H, W, s), s)

    def seq():
        # origins on the host: each narrow's start is a host integer
        o_host = o_main.cpu().numpy().astype(np.int64)

        def call():
            tot = torch.zeros((), dtype=torch.float64, device=dev)
            for i in range(p.reps):
                for x, y in ((o_host + i) % p.span).tolist():
                    tot = tot + torch.sum(img.narrow(0, y, S).narrow(1, x, S), dtype=torch.float64)
            return tot

        return call

    table = {"floor": (repeat(lambda o: img[:S, :S] + o[0, 0], o_main, p), None)}
    n_sweep, s_sweep = SWEEPS[small]
    for n in n_sweep:
        table[f"gather_n{n}_s{S}"] = (repeat(gather(S), make_origins(dev, n, small), p), (n, S))
    for s in s_sweep:
        table[f"gather_n{N}_s{s}"] = (repeat(gather(s), o_main, p), (N, s))
    table["seq"] = (seq(), (N, S))
    for nbuf in NBUF:
        table[f"kernel_nbuf{nbuf}"] = (repeat(kernel_call(img, p, nbuf), o_main, p), (N, S))
    return table


def e4_check(img: torch.Tensor, p: Shape, nbuf: int, small: bool) -> bool:
    """E4's smoke check: patches 0, N // 2 and N - 1 of one kernel call
    equal a direct slice of the image at their origins."""
    o = make_origins(img.device, p.points, small)
    out = kernel_call(img, p, nbuf)(o)
    S = p.size
    ok = True
    for i in (0, p.points // 2, p.points - 1):
        x, y = o[i].tolist()
        ok &= bool(torch.equal(out[i], img[y : y + S, x : x + S]))
    return ok


def run(variants=None, device="cuda", small: bool = False) -> dict:
    """Run the variants (all by default); {name: {ms, us_per_call,
    ns_per_point, value, patches}} (kernel rows also `correct`, E4's
    check), value the float64 sum of the REPS calls' outputs."""
    dev = torch.device(device)
    p = shape(small)
    print(card_line(dev), flush=True)
    img = make_image(dev, small).float()
    table = cases(img, p, small)
    out = {}
    for name in select(table, variants):
        fn, patches = table[name]
        value, ms = timed(fn, dev)
        points = patches[0] if patches else 1
        us, ns = per_call(ms, p.reps, points)
        out[name] = dict(ms=ms, us_per_call=us, ns_per_point=ns, value=float(value),
                         patches=patches)
        if name.startswith("kernel_nbuf"):
            nbuf = int(name.removeprefix("kernel_nbuf"))
            out[name]["correct"] = e4_check(img, p, nbuf, small)
            print(f"# kernel nbuf={nbuf} correct={out[name]['correct']}", flush=True)
        print(rep_line(name, ms, p.reps, points), flush=True)
    return out


def main(argv=None) -> int:
    return main_on_card(run, sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    raise SystemExit(main())
