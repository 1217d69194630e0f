"""Share of the pods due in the window whose binds the API server
accepted within 100 ms of their due time, in %; a pod never bound is
not among them."""


def read(rec, ctx):
    lat = rec.get("latency_s")
    if lat is None or not rec["attempted"]:
        return None
    return 100.0 * sum(1 for x in lat if x <= 0.1) / rec["attempted"]
