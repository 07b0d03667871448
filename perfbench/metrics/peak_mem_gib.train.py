"""``peak_mem_gib.train``: ``torch.cuda.max_memory_allocated`` over the
window (reset when set-up ends), in GiB."""


def read(window):
    if not window.peak_bytes:
        return None
    return window.peak_bytes / 2 ** 30
