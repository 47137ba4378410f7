"""Seconds from the start of the process to the opening of the window:
imports, weights, EAMC warm-up, the server (and its host store), the
warm prefill buckets and one finished request a client (host clock)."""


def read(rec):
    return rec["setup_s"]
