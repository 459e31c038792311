"""Mean refinement wall per call in milliseconds, from each Solution's
``pp_time`` (per trajectory, sync timing) times the trajectories it
covers."""


def read(run):
    if not run.config["post_processor"]:
        return None
    calls = run.window.done
    return 1e3 * sum(c.pp_s for c in calls) / len(calls) if calls else None
