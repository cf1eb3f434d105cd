"""The share of tracked points whose entry-level LK iterate ended within
1 px of its search margin, the signature of a coarse stage that left the
point out of LK's reach: 100 x the program's `lk_edge_points` count over
pairs x grid points, over the window's recorded requests. A program
without the count reads as nothing."""

from portbench.metrics import program
from portbench.reference.truth import grid_points


def read(ctx):
    recs = program.recorders(ctx)
    edge, pairs = program.counted(recs, "lk_edge_points"), program.counted(recs, "pairs")
    if edge is None or not pairs:
        return None
    cam = ctx.cell.config["camera"]
    n = len(grid_points(int(cam["width"]), int(cam["height"]),
                        int(ctx.cell.config["tracker"]["grid_step"])))
    return 100.0 * edge / (pairs * n)
