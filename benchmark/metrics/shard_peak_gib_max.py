"""The fullest card's torch.cuda.max_memory_allocated() over the run's
cards, as the check module read it after the drain and before the
reference ran (GiB); device_peak_gib reads card 0 alone."""


def read(run):
    peaks = getattr(run, "card_peaks", None)
    return max(peaks) / 2**30 if peaks else None
