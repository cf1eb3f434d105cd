"""The tracker's coarse stage: host milliseconds inside the program's
`track.coarse` spans (the global shift and the cost volume, its children
`coarse.global` and `coarse.volume` included) per frame pair, the pairs
counted by the program's `pairs` count, over the window's recorded
requests. The spans time the host's enqueue; the stage waits for no
device result."""

from portbench.metrics import program


def read(ctx):
    recs = program.recorders(ctx)
    secs, pairs = program.span_s(recs, "track.coarse"), program.counted(recs, "pairs")
    return 1e3 * secs / pairs if secs is not None and pairs else None
