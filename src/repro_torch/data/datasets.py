"""Synthetic analogues of the paper's six evaluation datasets (Tables 1-3).

The real datasets (MNIST, Covertype, RWHAR, WADI, SMD, proprietary VEHICLE)
are unavailable offline (repro band 2), so each generator produces data with
the same post-preprocessing dimensionality, number of underlying classes,
partitioning scheme, and OOD construction as the paper:

  mnist_like     24 feats (PCA from procedural 16x16 digit images), 10 classes
  covertype_like 10 feats, 7 terrain classes; OOD = +N(0, 0.005) noise
  rwhar_like     16 feats (PCA from 63 synthetic IMU channels), 13 persons;
                 inlier = walking dynamics, OOD = running dynamics
  wadi_like      84 feats, 10 artificial classes built exactly as the paper
                 does (shift by 1*(m-1)*beta + N(0, 0.01)); OOD = attack mode
  vehicle_like   11 feats, 3 operating environments; OOD = induced air leak
  smd_like       38 feats, 28 server machines; OOD = observed malfunctions

All features are min-max normalized to [0,1] on the training split; OOD data
is transformed with the *training* scaler/PCA, as in the paper.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from repro_torch.data.pca import fit_pca, transform_pca
from repro_torch.data.preprocess import fit_minmax


class Dataset(NamedTuple):
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test_in: np.ndarray
    x_test_ood: np.ndarray
    n_classes: int
    scheme: str          # default partitioning scheme (Table 1)
    k_global: int        # GMM components for the global model (Table 3)
    n_clients: int       # Table 3
    anomaly_ratio: float # Table 2


def _finalize(name, x_tr, y_tr, x_in, x_ood, n_classes, scheme, k, clients,
              ratio) -> Dataset:
    scaler = fit_minmax(x_tr)
    return Dataset(name, scaler.transform(x_tr), y_tr.astype(np.int64),
                   scaler.transform(x_in), scaler.transform(x_ood),
                   n_classes, scheme, k, clients, ratio)


# ----------------------------------------------------------------------
# MNIST-like: procedural digit images -> PCA(24)
# ----------------------------------------------------------------------

def _digit_images(rng: np.random.Generator, n: int, n_classes: int = 10,
                  size: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """Random smooth per-class stroke templates + jitter + pixel noise."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / (size - 1)
    templates = []
    for m in range(n_classes):
        trng = np.random.default_rng(1000 + m)  # fixed class identity
        img = np.zeros((size, size))
        for _ in range(4):  # 4 gaussian strokes per class
            cx, cy = trng.uniform(0.15, 0.85, 2)
            sx, sy = trng.uniform(0.05, 0.25, 2)
            rot = trng.uniform(0, np.pi)
            dx, dy = xx - cx, yy - cy
            u = np.cos(rot) * dx + np.sin(rot) * dy
            v = -np.sin(rot) * dx + np.cos(rot) * dy
            img += np.exp(-(u ** 2 / (2 * sx ** 2) + v ** 2 / (2 * sy ** 2)))
        templates.append(img / img.max())
    y = rng.integers(0, n_classes, n)
    imgs = np.stack([templates[c] for c in y])
    # random shift by up to 2px via roll, amplitude jitter, pixel noise
    shifts = rng.integers(-2, 3, size=(n, 2))
    for i in range(n):
        imgs[i] = np.roll(imgs[i], shifts[i], axis=(0, 1))
    imgs = imgs * rng.uniform(0.7, 1.3, (n, 1, 1))
    imgs = imgs + rng.normal(0, 0.08, imgs.shape)
    return imgs.astype(np.float32), y


def _ood_images(imgs: np.ndarray) -> np.ndarray:
    """The paper's MNIST OOD: rotate 90 ccw, flip horizontally, scale 1.2."""
    out = np.rot90(imgs, k=1, axes=(1, 2))
    out = out[:, :, ::-1]
    return 1.2 * out


def mnist_like(rng: np.random.Generator, n_train: int = 6000,
               n_test: int = 1200) -> Dataset:
    n_ood = int(n_test * 0.10)
    imgs, y = _digit_images(rng, n_train + n_test + n_ood)
    flat = imgs.reshape(len(imgs), -1)
    pca = fit_pca(flat[:n_train], 24)
    tr = transform_pca(pca, flat[:n_train])
    te = transform_pca(pca, flat[n_train:n_train + n_test])
    ood = transform_pca(pca, _ood_images(imgs[n_train + n_test:]).reshape(n_ood, -1))
    return _finalize("mnist", tr, y[:n_train], te, ood, 10, "dirichlet",
                     30, 20, 0.10)


# ----------------------------------------------------------------------
# Covertype-like: 10 tabular features, 7 terrain classes
# ----------------------------------------------------------------------

def covertype_like(rng: np.random.Generator, n_train: int = 20000,
                   n_test: int = 4000) -> Dataset:
    n_classes, d = 7, 10
    n_ood = int(n_test * 0.10)
    n = n_train + n_test + n_ood
    y = rng.integers(0, n_classes, n)
    crng = np.random.default_rng(42)
    mus = crng.uniform(0, 1, (n_classes, d))
    # correlated, skewed class clouds (terrain variables are correlated)
    mix = crng.normal(0, 1, (n_classes, d, d)) * 0.035
    z = rng.normal(0, 1, (n, d))
    x = mus[y] + np.einsum("nij,nj->ni", mix[y], z)
    x += 0.3 * np.sin(3 * x[:, [0]]) * crng.uniform(0, 1, (1, d))  # mild nonlinearity
    x_tr, x_te = x[:n_train], x[n_train:n_train + n_test]
    # paper OOD: additive Gaussian noise, zero mean, variance 0.005
    x_ood = x[n_train + n_test:] + rng.normal(0, np.sqrt(0.005),
                                              (n_ood, d))
    return _finalize("covertype", x_tr, y[:n_train], x_te, x_ood, n_classes,
                     "dirichlet", 15, 20, 0.10)


# ----------------------------------------------------------------------
# RWHAR-like: 16 feats (PCA from 63 IMU channels), 13 persons
# ----------------------------------------------------------------------

def _imu_features(rng, y, activity: str):
    """Windowed IMU summary features for person y doing an activity."""
    n = len(y)
    prng = np.random.default_rng(7)
    person_gain = prng.uniform(0.6, 1.4, (13, 63))
    person_off = prng.normal(0, 0.3, (13, 63))
    if activity == "walking":
        freq, amp = 1.8, 1.0
    else:  # running
        freq, amp = 3.2, 2.4
    base_phase = rng.uniform(0, 2 * np.pi, (n, 1))
    ch = np.arange(63)[None, :] / 63.0
    feats = amp * np.sin(freq * 2 * np.pi * ch * 4 + base_phase)
    feats = feats * person_gain[y] + person_off[y]
    feats += rng.normal(0, 0.25, feats.shape)
    return feats.astype(np.float32)


def rwhar_like(rng: np.random.Generator, n_train: int = 12000,
               n_test: int = 2500) -> Dataset:
    n_ood = int(n_test * 0.10)
    y = rng.integers(0, 13, n_train + n_test)
    y_ood = rng.integers(0, 13, n_ood)
    walk = _imu_features(rng, y, "walking")
    run = _imu_features(rng, y_ood, "running")
    pca = fit_pca(walk[:n_train], 16)
    tr = transform_pca(pca, walk[:n_train])
    te = transform_pca(pca, walk[n_train:])
    ood = transform_pca(pca, run)
    return _finalize("rwhar", tr, y[:n_train], te, ood, 13, "dirichlet",
                     15, 20, 0.10)


# ----------------------------------------------------------------------
# WADI-like: 84 sensor features; classes built exactly as in the paper
# ----------------------------------------------------------------------

def wadi_like(rng: np.random.Generator, n_train: int = 15000,
              n_test: int = 3000, beta: float = 0.3,
              n_classes: int = 10) -> Dataset:
    d = 84
    n_ood = int(n_test * 0.06 / (1 - 0.06)) + 1
    n = n_train + n_test
    # base process: slow AR(1) drift per sensor + correlated station noise
    wrng = np.random.default_rng(11)
    loading = wrng.normal(0, 1, (8, d)) * 0.2
    t = rng.normal(0, 1, (n + n_ood, 8))
    base = 0.5 + t @ loading + rng.normal(0, 0.05, (n + n_ood, d))
    # paper: class m adds center 1*(m-1)*beta with diagonal covariance 0.01
    y = rng.integers(0, n_classes, n + n_ood)
    x = base + (y[:, None] - 1) * beta * 0.1 + rng.normal(
        0, 0.1, (n + n_ood, d))
    # attack mode: a coordinated push on a sensor subset (valve/pump group)
    attacked = wrng.choice(d, 12, replace=False)
    x_ood = x[n:].copy()
    x_ood[:, attacked] += rng.uniform(0.8, 1.6, (n_ood, 1)) * np.sign(
        wrng.normal(0, 1, (1, 12)))
    return _finalize("wadi", x[:n_train], y[:n_train], x[n_train:n], x_ood,
                     n_classes, "quantity", 10, 20, 0.06)


# ----------------------------------------------------------------------
# VEHICLE-like: 11 air-pressure-system signals, 3 environments
# ----------------------------------------------------------------------

def vehicle_like(rng: np.random.Generator, n_train: int = 9000,
                 n_test: int = 3000) -> Dataset:
    d, n_classes = 11, 3
    n_ood = n_test // 2  # 50% anomaly ratio (Table 2)
    n = n_train + n_test // 2
    y = rng.integers(0, n_classes, n)
    # environments: city (stop-go), highway (steady), test track (aggressive)
    env_mu = np.array([[0.55] * d, [0.75] * d, [0.45] * d])
    env_var = np.array([0.15, 0.05, 0.25])
    vrng = np.random.default_rng(5)
    chan = vrng.uniform(0.5, 1.5, d)
    x = env_mu[y] * chan + rng.normal(0, 1, (n, d)) * env_var[y][:, None] * chan
    # compressor duty cycle couples channels 0-3
    duty = rng.uniform(0, 1, (n, 1))
    x[:, :4] += 0.3 * duty
    y_ood = rng.integers(0, n_classes, n_ood)
    x_ood = env_mu[y_ood] * chan + rng.normal(0, 1, (n_ood, d)) * \
        env_var[y_ood][:, None] * chan
    x_ood[:, :4] += 0.3 * rng.uniform(0, 1, (n_ood, 1))
    # induced air leakage: pressure channels sag, compressor overworks
    leak = rng.uniform(0.25, 0.6, (n_ood, 1))
    x_ood[:, :4] -= leak
    x_ood[:, 4:7] += 0.5 * leak
    return _finalize("vehicle", x[:n_train], y[:n_train], x[n_train:],
                     x_ood, n_classes, "quantity", 15, 12, 0.50)


# ----------------------------------------------------------------------
# SMD-like: 38 server metrics, 28 machines
# ----------------------------------------------------------------------

def smd_like(rng: np.random.Generator, n_train: int = 20000,
             n_test: int = 5000) -> Dataset:
    d, n_classes = 38, 28
    n_ood = int(n_test * 0.04 / (1 - 0.04)) + 1
    n = n_train + n_test
    srng = np.random.default_rng(13)
    machine_mu = srng.uniform(0.2, 0.8, (n_classes, d))
    machine_scale = srng.uniform(0.02, 0.12, (n_classes, d))
    y = rng.integers(0, n_classes, n + n_ood)
    # load factor drives cpu/mem/net metrics jointly
    load = rng.beta(2, 5, (n + n_ood, 1))
    coupling = srng.uniform(0, 0.6, (1, d))
    x = machine_mu[y] + load * coupling + rng.normal(0, 1, (n + n_ood, d)) * \
        machine_scale[y]
    x_ood = x[n:].copy()
    # malfunctions: per-event random subset of metrics spikes or flatlines
    for i in range(n_ood):
        k = rng.integers(3, 9)
        chans = rng.choice(d, k, replace=False)
        if rng.uniform() < 0.5:
            x_ood[i, chans] += rng.uniform(0.5, 1.2)   # spike
        else:
            x_ood[i, chans] = machine_mu[y[n + i], chans] * 0.1  # flatline
    return _finalize("smd", x[:n_train], y[:n_train], x[n_train:n], x_ood,
                     n_classes, "dirichlet", 10, 20, 0.04)


REGISTRY: dict[str, Callable[..., Dataset]] = {
    "mnist": mnist_like,
    "covertype": covertype_like,
    "rwhar": rwhar_like,
    "wadi": wadi_like,
    "vehicle": vehicle_like,
    "smd": smd_like,
}


def load(name: str, rng: np.random.Generator | None = None, **kw) -> Dataset:
    if rng is None:
        rng = np.random.default_rng(0)
    return REGISTRY[name](rng, **kw)
