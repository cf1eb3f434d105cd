"""Every window of the request at once, as `run_batched` chains the
recipe's stages: `track_clip` over the windows' pairs, `syncpoint_windows`,
one batched PreSync (`presync_stage`) and the batched Sync passes
(`sync_stage`), ending on the host read of the final delays."""


def run(d, req, spans):
    sp = d.new_problem(req, spans)
    starts = d.track(sp, req, spans)
    i = req.index
    with spans("windows", i):
        open_w, closed_w = d.recipe.syncpoint_windows(sp, starts, d.window)
    with spans("presync", i):
        req.presync = d.recipe.presync_stage(sp, open_w, d.initial_delay, d.radius_ms,
                                             d.step_ms)
    with spans("sync4x", i):
        res = d.recipe.sync_stage(sp, closed_w, req.presync, d.initial_delay,
                                  d.radius_ms / 1000.0, d.motion_opt)
        req.final = res[-1].delay.double().cpu().tolist()
    return sp
