"""Host synchronisations of one train step, counted under CUDA's sync
debug mode on one step after the window (``torch.cuda.
set_sync_debug_mode``, as ``dir_tpu_torch/bench.py`` counts them)."""


def read(found):
    return found.get("counters", {}).get("host_syncs_per_step")
