"""device_memory_gb: the card's memory the cell's queries hold at their
peak, in GB: torch's allocator peak on the card over set-up and the window
(the run's memory_peak_bytes), as nvidia-smi would show a user sharing the
card. Nothing on a run without a card."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 1e9
