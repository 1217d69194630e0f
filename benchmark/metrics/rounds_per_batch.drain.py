"""Conflict loop: rounds per batch over the window, from the rounds the
conflict loop returns."""

def read(rec, ctx):
    if not rec.get("batches"):
        return None
    return rec["rounds"] / rec["batches"]
