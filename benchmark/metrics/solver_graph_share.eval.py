"""``solver_graph_share.eval``: the share, in %, of the calls of the program's graphed solver stages (``eval.solver.prepare``, ``solver.select``, ``solver.init``, ``solver.refine``, ``solver.finalize``, ``eval.solver.score``) in the traced run's profiled steps that replayed a captured CUDA graph, rather than running eagerly or capturing one, as the program's span recorder counts them (``span_summary()["graphs"]``). None without that counter or without a call of a solver stage."""
import program_spans

STAGES = ("solver.", "eval.solver.")


def read(record):
    if record.get("mode") != "eval":
        return None
    from satellite_pose_estimation_tpu_torch.utils import profiling
    s = program_spans.summary(profiling)
    if s is None or "graphs" not in s:
        return None
    calls = [g for name, g in s["graphs"].items() if name.startswith(STAGES)]
    total = sum(g["eager"] + g["captures"] + g["replays"] for g in calls)
    return 100.0 * sum(g["replays"] for g in calls) / total if total else None
