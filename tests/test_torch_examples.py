"""The port's seven examples (``examples/torch/*.py``) run on the CPU at the
JAX examples' own sizes, each through its ``main(["--device", "cpu"])``,
and held to the numbers of the JAX examples on the CPU (recorded in the
comments below). Torch's random streams differ from JAX's, so a number
that depends on a draw is held within a stated margin, and one that does
not is held exactly. The limits are ``chip_smoke.example_failures``, which
holds phase 16's runs on the card to the same. ``train_transformer`` runs 8
of its 200 steps here."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
NAMES = ("quickstart", "anomaly_detection", "continual_fl",
         "federated_sharded", "out_of_core", "serve_anomaly",
         "train_transformer")
CPU = ["--device", "cpu"]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _limits():
    spec = importlib.util.spec_from_file_location("chip_smoke_limits",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.example_failures


def _held(name, out):
    assert _limits()(name, out) == [], out


def test_every_reference_example_has_its_counterpart():
    ref = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert ref == sorted(NAMES)
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_the_default_device_needs_a_card(name, capsys):
    """``--device`` defaults to cuda; with no card the example stops with a
    message that names ``--device cpu``, before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        _load(name).main([])
    assert capsys.readouterr().out == ""


def test_quickstart():
    # examples/quickstart.py on the CPU: client sizes [264 111 22 526 240
    # 463 282 214 156 722]; 1 round, 690 uplink floats against 24,000 raw;
    # federated avg log-likelihood -8.7026, central -8.6081. The split is
    # numpy and held exactly; S is a draw (federated within 0.25), the
    # central fit within 0.05.
    _held("quickstart", _load("quickstart").main(CPU))


def test_continual_fl():
    # examples/continual_fl.py on the CPU, window 3: memory 0 ll_old
    # -408.77, ll_new -3.59; memory 0.6 ll_old -4.66, ll_new -4.00;
    # rounds_total 1, 2, 3, 4 under both. Held: rounds exactly, memory 0's
    # ll_old below -100, the others within 0.3.
    _held("continual_fl", _load("continual_fl").main(CPU))


def test_out_of_core():
    # examples/out_of_core.py on the CPU: mmap fit -5.354 in 2 EM
    # iterations over 60,000 rows; concat fit bit-identical; FedGenGMM over
    # sources -5.360 with |S| = 1,800; replay score -5.387 over 10,000,000
    # virtual rows. Held: the bits and sizes exactly, the three
    # log-likelihoods within 0.02, 0.05 and 0.1.
    _held("out_of_core", _load("out_of_core").main(CPU))


def test_anomaly_detection():
    # examples/anomaly_detection.py on the CPU, AUC-PR / loglik / rounds:
    #   alpha 1: fedgen 0.950 / 11.758 / 1, central 0.943 / 11.887 / 0
    #   alpha 2: fedgen 0.950 / 11.753 / 1, central 0.943 / 11.887 / 0
    # (local, dem1-3 as in chip_smoke.ANOMALY_OPTIMA's comment). Over 12
    # seeds (tools/anomaly_optima.py jax) each method lands in one of a few
    # optima, fedgen 11.390-11.393, 11.751-11.760, 11.809 or 11.855 and
    # central 11.427, 11.788-11.795 or 11.884-11.889. Held: fedgen one
    # round; fedgen's, DEM's and central's loglik within 0.02 of one of the
    # reference's optima, the local models' within 0.5 of the reference's
    # range, every AUC-PR within 0.01 of the reference's range, at both
    # alphas.
    out = _load("anomaly_detection").main(CPU)
    assert sorted(out) == ["1", "2"]
    _held("anomaly_detection", out)


def test_federated_sharded_in_its_own_process():
    # examples/federated_sharded.py on the CPU (8 host devices): FedGenGMM
    # -5.7552; DEM 4 rounds, -5.7491; central -5.7491. The port runs one
    # gloo rank here, in a process of its own (it makes the group). Held:
    # FedGenGMM within 0.05, DEM 1-10 rounds, DEM and central within 0.01.
    code = ("import json, sys, importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('ex', "
            f"{str(EXAMPLES / 'federated_sharded.py')!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "print(json.dumps(mod.main(['--device', 'cpu'])))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    _held("federated_sharded",
          json.loads(proc.stdout.strip().splitlines()[-1]))


def test_serve_anomaly():
    # examples/serve_anomaly.py on the CPU, with its wrapper's protocol
    # members spelled out (as is, its trainer raises on Python 3.12 and its
    # main thread waits for ever): 390 batches over versions 1-9, ID score
    # 7.14 and OOD 1133.89 under v9. Held: every version served in order,
    # the last one at the end, ID within 1.0 and OOD within 10%.
    _held("serve_anomaly", _load("serve_anomaly").main(CPU))


def test_train_transformer():
    # examples/train_transformer.py on the CPU: 6.223 -> 3.496 in 200 steps.
    # Held: the first loss within 0.1, a fall of 0.5 or more, a checkpoint.
    out = _load("train_transformer").main(CPU + ["--steps", "8"])
    assert out["steps"] == 8
    _held("train_transformer", out)
