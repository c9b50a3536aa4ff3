"""``peak_reserved_gib``: ``torch.cuda.max_memory_reserved`` over the whole
process, set-up included, on the card that reserved most, read when the
window closes (before the reference runs)."""


def read(view: dict):
    peak = view["peak_reserved_bytes"]
    return peak / float(1 << 30) if peak else None
