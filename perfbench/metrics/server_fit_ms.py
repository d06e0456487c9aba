"""Mean wall of the server's half of the round (the span around
``repro_torch.core.fedgen.aggregate_cfg``: merge, synthetic rows, refit),
in ms."""


def read(t):
    n = t.span_calls.get("server_fit", 0)
    return 1e3 * t.span_s["server_fit"] / n if n else None
