"""Conflict loop: the CUDA runtime's synchronising calls in the traced
stretch per batch scheduled in it."""

def read(rec, ctx):
    tr = rec.get("trace")
    if not tr or not rec.get("stretch_batches"):
        return None
    return tr["host_syncs"] / rec["stretch_batches"]
