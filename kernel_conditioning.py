#!/usr/bin/env python3
"""How well the examples' own kernel inputs are conditioned, on one NVIDIA
card: each GMM example of ``examples/torch`` runs through its ``main``
while the first inputs of each shape that each kernel entry is given are
copied (``chip_smoke.recording_inputs``); then every copy goes through the
kernel, its plain version in f32 (on the card and on the host CPU) and
its plain version in f64.

    python3 kernel_conditioning.py

Prints a line a (example, entry, shapes): for each output, the largest
absolute difference kernel - plain, kernel - f64, plain - f64 and the
host's plain - f64, and the largest |f64|; for a log density, the f32
forward-error bound of one evaluation of its packed logits
``x*x @ a + x @ b + c`` (2d + 2 roundings of the terms' absolute sum; for
``estep_stats`` the responsibility- and row-weighted sum over the rows,
the bound on its log-likelihood).
"""
import contextlib
import io
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EXAMPLES = ("quickstart", "anomaly_detection", "continual_fl",
            "federated_sharded", "out_of_core", "serve_anomaly")


def logit_bound(x, a, b, c):
    """The f32 bound of one evaluation of the packed logits, (..., N, K),
    in f64."""
    x, a, b, c = (t.double() for t in (x, a, b, c))
    m = 2 * x.shape[-1] + 2
    gamma = m * 2.0 ** -24 / (1 - m * 2.0 ** -24)
    return gamma * ((x * x).abs() @ a.abs() + x.abs() @ b.abs()
                    + c.abs().unsqueeze(-2))


def row_bound(x, a, b, c):
    """``logit_bound`` through a row's log-sum-exp, to first order,
    (..., N)."""
    import torch
    x64, a64, b64, c64 = (t.double() for t in (x, a, b, c))
    resp = torch.softmax(x64 * x64 @ a64 + x64 @ b64 + c64.unsqueeze(-2), -1)
    return (resp * logit_bound(x, a, b, c)).sum(-1)


def compare(entry, args):
    """([kernel - plain, kernel - f64, plain - f64, plain on the host CPU -
    f64, max |f64|] of each floating output, the bound or None)."""
    import torch
    from repro_torch.kernels import estep_stats, gmm_logpdf, kmeans_assign
    from repro_torch.kernels import ref
    a64 = [t.double() if isinstance(t, torch.Tensor) else t for t in args]
    bound = None
    if entry == "estep_stats":
        kern, plain = estep_stats.estep_stats, ref.estep_stats_packed
        x, w, a, b, c = args
        bound = float((w.double() * row_bound(x, a, b, c)).sum(-1).max())
    elif entry == "gmm_log_prob":
        kern, plain = gmm_logpdf.gmm_log_prob, ref.gmm_log_prob_packed
        bound = float(row_bound(*args).max())
    elif entry == "gmm_logpdf":
        kern, plain = gmm_logpdf.gmm_logpdf, ref.gmm_logpdf_packed
        bound = float(logit_bound(*args).max())
    elif entry == "kmeans_assign":
        kern, plain = kmeans_assign.kmeans_assign, ref.kmeans_assign_packed
    else:
        args, a64 = args[:4], a64[:4]
        kern = lambda *t: kmeans_assign.kmeans_sweep_stats(  # noqa: E731
            *t, with_idx=True)
        plain = ref.kmeans_sweep_packed
    host = [t.cpu() if isinstance(t, torch.Tensor) else t for t in args]
    outs = [kern(*args), plain(*args), plain(*host), plain(*a64)]
    outs = [o if isinstance(o, (tuple, list)) else (o,) for o in outs]
    rows = []
    for g, p, h, t in zip(*outs):
        if g is None or not torch.is_floating_point(g):
            continue
        g, p, h, t = (o.double().cpu() for o in (g, p, h, t))
        rows.append([float((g - p).abs().max()), float((g - t).abs().max()),
                     float((p - t).abs().max()), float((h - t).abs().max()),
                     float(t.abs().max())])
    torch.cuda.synchronize()
    return rows, bound


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("kernel_conditioning.py needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    print(chip_smoke.card_line(), flush=True)
    _build.build()
    for name in EXAMPLES:
        store: dict = {}
        mod = chip_smoke.load_example(name)
        with contextlib.redirect_stdout(io.StringIO()), \
                chip_smoke.recording_inputs(store):
            mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        for (entry, *shapes), args in sorted(store.items(), key=str):
            rows, bound = compare(entry, args)
            print(f"{name} {entry} {tuple(shapes)}: [kernel-plain, "
                  f"kernel-f64, plain-f64, host plain-f64, max|f64|] "
                  f"{[[float(f'{v:.4g}') for v in r] for r in rows]}; "
                  f"f32 bound {bound if bound is None else f'{bound:.4g}'}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
