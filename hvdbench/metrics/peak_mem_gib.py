"""The largest ``torch.cuda.max_memory_allocated()`` over the ranks,
reset before the first window step, in GiB."""


def read(run):
    return max(r["peak_bytes"] for r in run["ranks"]) / 2 ** 30
