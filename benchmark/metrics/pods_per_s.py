"""Pods whose binds the API server accepted in the window, per second of it."""

def read(rec, ctx):
    return rec.get("pods_per_s")
