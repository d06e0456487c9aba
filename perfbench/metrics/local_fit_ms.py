"""Mean wall of the clients' local fits (the span around
``repro_torch.core.fedgen.train_locals_cfg``), in ms."""


def read(t):
    n = t.span_calls.get("local_fit", 0)
    return 1e3 * t.span_s["local_fit"] / n if n else None
