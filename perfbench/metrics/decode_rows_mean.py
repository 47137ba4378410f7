"""Active rows in each pooled decode step of the window, on average (the
harness counts them)."""


def read(rec):
    rows = rec["decode_rows"]
    return sum(rows) / len(rows) if rows else None
