from .log import log, set_log_stream, Timer


def default_threads(cap: int = 4) -> int:
    """Worker count for threaded native kernels: LR2RMATS_THREADS wins,
    else min(cap, cpu_count) — the 4-cap is tuned to the 4-core dev rig;
    bigger hosts raise the env knob (README env-knob table)."""
    import os
    env_t = os.environ.get("LR2RMATS_THREADS")
    if env_t:
        return max(1, int(env_t))
    return max(1, min(cap, os.cpu_count() or 1))
