"""Byzantine and straggler fault injection: the five fault families of
``repro.fed.faults_device``, in PyTorch.

A family corrupts the (M, P) FLAT panel of locally trained client params
(``aggregator_device`` layout, keys sorted) between local training and the
server update:

    ``corrupt(fparams, state, updf, prevf, avail, t, sel, valid, *,
              noise=None, innovations=None) -> (updf, state)``

  =============== ===================== ==================================
  family          class                 corrupted update of a byz slot
  =============== ===================== ==================================
  none            NoFault               identity
  sign_flip       SignFlipFault         ``prev − scale (theta_k − prev)``
  gaussian_noise  GaussianNoiseFault    ``theta_k + sigma eps``
  scaled          ScaledFault           ``prev + boost (theta_k − prev)``
  straggler_stale StragglerStaleFault   the client's last on-time update (a
                                        row of the carried (N, P) stale
                                        panel) while its AR(1) latency
                                        ``l' = rho l + (1 − rho) mu_k +
                                        sigma eps`` is past the deadline
  =============== ===================== ==================================

Which clients are adversarial is a fixed host mask (``byz``): ``ceil(frac
N)`` clients of a ``default_rng(byz_seed)`` permutation; the straggler's
mean latencies ``mu`` are a ``default_rng(mu_seed)`` uniform draw — both
numpy, so both are bitwise the reference's.  A slot is corrupted iff its
client is in the mask and the slot is valid.

RNG seam: the reference draws the gaussian noise, the AR(1) innovations and
the straggler's initial latency from ``jax.random`` keys, which torch cannot
replay.  Each is an injected standard-normal tensor here (``noise`` (M, P),
``innovations`` (N,), the init draw (N,)); :class:`HostFaultInjector` draws
them from a CPU ``torch.Generator`` seeded from (fault_seed, t) unless a
``draws`` callable supplies them (the parity tests pass the reference's).
The straggler updates its stale panel in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.fed.aggregator_device import _flat_template

FAMILIES = ("none", "sign_flip", "gaussian_noise", "scaled",
            "straggler_stale")

THETA_DIM = 6          # packed per-family scalar knobs (see the branches)

# SeedSequence salts of the default draws: (fault_seed, t, salt) per round;
# the init draw seeds from (fault_seed,) alone, so no two streams collide
_NOISE_SALT = 1
_STEP_SALT = 2


# ------------------------------------------------------------ state helpers
def init_fault_state(state: dict, params0: dict, stale_rows: int) -> dict:
    """Merge the flat (rows, P) stale panel into a process's state, every
    row flat(params0); ``stale_rows=0`` keeps an empty panel."""
    ravel, _, _ = _flat_template(params0)
    flat0 = ravel(params0)
    return {**state, "stale": flat0[None, :].repeat(stale_rows, 1)}


def device_params(fparams: dict, device) -> dict:
    """A process's host ``params()`` with ``byz`` / ``aux`` as tensors on
    ``device`` (``theta`` stays host float32)."""
    return {**fparams,
            "byz": torch.as_tensor(np.asarray(fparams["byz"], bool),
                                   device=device),
            "aux": torch.as_tensor(np.asarray(fparams["aux"], np.float32),
                                   device=device)}


# ------------------------------------------------------- per-family branches
# Each: (theta (host floats), fp, state, updf (M, P), prevf (P,), sel,
# valid, byzm (M,), noise, innovations) -> (updf, state)
def _corrupt_none(th, fp, state, updf, prevf, sel, valid, byzm, noise, innov):
    return updf, state


def _corrupt_sign_flip(th, fp, state, updf, prevf, sel, valid, byzm, noise,
                       innov):
    flipped = prevf[None, :] - th[0] * (updf - prevf[None, :])
    return torch.where(byzm[:, None], flipped, updf), state


def _corrupt_gaussian(th, fp, state, updf, prevf, sel, valid, byzm, noise,
                      innov):
    if noise is None:
        raise ValueError("gaussian_noise needs its (M, P) noise draw")
    return torch.where(byzm[:, None], updf + th[0] * noise, updf), state


def _corrupt_scaled(th, fp, state, updf, prevf, sel, valid, byzm, noise,
                    innov):
    boosted = prevf[None, :] + th[0] * (updf - prevf[None, :])
    return torch.where(byzm[:, None], boosted, updf), state


def _corrupt_straggler(th, fp, state, updf, prevf, sel, valid, byzm, noise,
                       innov):
    if innov is None:
        raise ValueError("straggler_stale needs its (N,) innovation draw")
    rho, sigma, deadline = th[0], th[1], th[2]
    lat = rho * state["latency"] + (1.0 - rho) * fp["aux"] + sigma * innov
    late = byzm & (lat[sel] > deadline)
    stale = state["stale"]
    stale_rows = stale[sel]                              # pre-refresh read
    out = torch.where(late[:, None], stale_rows, updf)
    refresh = valid & ~late
    stale[sel] = torch.where(refresh[:, None], updf, stale_rows)
    return out, {**state, "latency": lat, "stale": stale}


_BRANCHES = {"none": _corrupt_none, "sign_flip": _corrupt_sign_flip,
             "gaussian_noise": _corrupt_gaussian, "scaled": _corrupt_scaled,
             "straggler_stale": _corrupt_straggler}


def make_fault_step(family: str):
    """The per-round corruption of one family,

        ``corrupt(fparams, state, updf, prevf, avail, t, sel, valid, *,
                  noise=None, innovations=None) -> (updf, state)``.

    ``fparams`` holds ``byz`` / ``aux`` as tensors on the panel's device
    (:func:`device_params`).  ``noise`` / ``innovations`` are the standard
    normal draws of the families that need them."""
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, not {family!r}")
    branch = _BRANCHES[family]

    def corrupt(fparams, state, updf, prevf, avail, t, sel, valid, *,
                noise=None, innovations=None):
        th = [float(x) for x in np.asarray(fparams["theta"], np.float32)]
        byzm = fparams["byz"][sel] & valid
        return branch(th, fparams, state, updf, prevf, sel, valid, byzm,
                      noise, innovations)

    return corrupt


# ------------------------------------------------------------ the processes
@dataclass
class FaultProcess:
    """Base class: ``params()`` packs the family index, float32 ``theta``,
    the (N,) ``byz`` mask and per-client ``aux`` (host numpy); ``init``
    builds the carried state; ``HostFaultInjector`` runs the family."""
    n: int
    frac: float = 0.0
    byz_seed: int = 0
    name: str = "none"

    family = "none"

    def _theta(self) -> np.ndarray:
        return np.zeros(0)

    def _aux(self) -> np.ndarray:
        return np.zeros(self.n)

    def byz_mask(self) -> np.ndarray:
        """(N,) bool: the ``ceil(frac * N)`` adversarial clients of a
        seeded permutation."""
        mask = np.zeros(self.n, bool)
        k = int(np.ceil(self.frac * self.n)) if self.frac > 0 else 0
        if k:
            rng = np.random.default_rng(self.byz_seed)
            mask[rng.permutation(self.n)[:k]] = True
        return mask

    def params(self) -> dict:
        theta = np.zeros(THETA_DIM, np.float32)
        th = np.asarray(self._theta(), np.float32)
        theta[:th.shape[0]] = th
        return {"family": FAMILIES.index(self.family), "theta": theta,
                "byz": self.byz_mask(),
                "aux": np.asarray(self._aux(), np.float32)}

    def init(self, eps: Optional[torch.Tensor] = None, *,
             device=None) -> dict:
        """Initial carried state on ``device`` (None means CUDA, and raises
        without it).  ``eps`` is the (N,) standard-normal init draw (only
        the straggler reads it).  The stale panel is merged in by
        :func:`init_fault_state`."""
        return {"latency": torch.zeros(
            self.n, dtype=torch.float32,
            device=resolve_device(device, who="FaultProcess.init"))}


@dataclass
class NoFault(FaultProcess):
    """The benign identity (every slot honest)."""
    name: str = "none"
    family = "none"


@dataclass
class SignFlipFault(FaultProcess):
    """Reversed update delta, optionally amplified (``scale`` > 1)."""
    frac: float = 0.2
    scale: float = 1.0
    name: str = "sign_flip"
    family = "sign_flip"

    def _theta(self):
        return np.array([self.scale])


@dataclass
class GaussianNoiseFault(FaultProcess):
    """Additive per-coordinate N(0, sigma^2) noise on byz updates."""
    frac: float = 0.2
    sigma: float = 1.0
    name: str = "gaussian_noise"
    family = "gaussian_noise"

    def _theta(self):
        return np.array([self.sigma])


@dataclass
class ScaledFault(FaultProcess):
    """Model-replacement boosting: the delta amplified ``boost``-fold."""
    frac: float = 0.2
    boost: float = 10.0
    name: str = "scaled"
    family = "scaled"

    def _theta(self):
        return np.array([self.boost])


@dataclass
class StragglerStaleFault(FaultProcess):
    """AR(1)-latency stragglers shipping their last on-time update:
    ``l' = rho l + (1 − rho) mu_k + sigma eps``, stationary init
    ``N(mu_k, sigma² / (1 − rho²))``."""
    frac: float = 0.3
    rho: float = 0.8
    sigma: float = 0.2
    deadline: float = 1.0
    mu: Optional[np.ndarray] = None      # (N,) mean latencies; default U[.5, 1.5]
    mu_seed: int = 0
    name: str = "straggler_stale"
    family = "straggler_stale"

    def _theta(self):
        return np.array([self.rho, self.sigma, self.deadline])

    def _mu(self) -> np.ndarray:
        if self.mu is not None:
            return np.asarray(self.mu, np.float64)
        rng = np.random.default_rng(self.mu_seed)
        return rng.uniform(0.5, 1.5, self.n)

    def _aux(self):
        return self._mu()

    @property
    def stationary_sd(self) -> float:
        return self.sigma / np.sqrt(max(1.0 - self.rho ** 2, 1e-12))

    def init(self, eps=None, *, device=None):
        if eps is None:
            raise ValueError("straggler_stale needs its (N,) init draw")
        mu = torch.as_tensor(
            self._mu(), dtype=torch.float32,
            device=resolve_device(device, who="StragglerStaleFault.init"))
        return {"latency": mu + float(self.stationary_sd) * eps.to(mu)}


def make_fault_process(name: str, n_clients: int, *, frac: float = 0.2,
                       byz_seed: int = 0, **kw) -> FaultProcess:
    """Family names -> processes; extra kwargs reach the family
    constructor (scale / sigma / boost / rho / deadline / ...)."""
    name = name.lower()
    if name == "none":
        return NoFault(n_clients)
    if name == "sign_flip":
        return SignFlipFault(n_clients, frac=frac, byz_seed=byz_seed, **kw)
    if name == "gaussian_noise":
        return GaussianNoiseFault(n_clients, frac=frac, byz_seed=byz_seed,
                                  **kw)
    if name == "scaled":
        return ScaledFault(n_clients, frac=frac, byz_seed=byz_seed, **kw)
    if name in ("straggler_stale", "straggler"):
        return StragglerStaleFault(n_clients, frac=frac, byz_seed=byz_seed,
                                   **kw)
    raise ValueError(f"unknown fault family {name!r}")


# ---------------------------------------------------------------- host face
def default_fault_draw(fault_seed: int, kind: str, t: Optional[int],
                       shape) -> torch.Tensor:
    """A float32 standard-normal draw from a CPU generator: ``kind`` "init"
    seeds from (fault_seed,), "noise" from (fault_seed, t, 1) and
    "innovations" from (fault_seed, t, 2).  A CPU run and a card run draw
    the same numbers."""
    if kind == "init":
        entropy = [fault_seed]
    else:
        salt = {"noise": _NOISE_SALT, "innovations": _STEP_SALT}[kind]
        entropy = [fault_seed, t, salt]
    state = np.random.SeedSequence(entropy).generate_state(1)
    gen = torch.Generator().manual_seed(int(state[0]))
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32)


class HostFaultInjector:
    """The engine's face over a fault family: ``init(params0)`` builds the
    state on params0's device, :meth:`inject` corrupts one round's stacked
    updates between local training and ``server.apply``.  ``draws(kind, t,
    shape) -> array`` replaces :func:`default_fault_draw` (the seam that
    lets a run replay the reference's ``jax.random`` draws)."""

    def __init__(self, process: FaultProcess, *, fault_seed: int = 0,
                 draws: Optional[Callable] = None):
        self.process = process
        self.n = int(process.n)
        self.fault_seed = int(fault_seed)
        self.draws = draws
        self._step = make_fault_step(process.family)
        self._fp = None
        self._flat = None
        self.state = None

    def _draw(self, kind: str, t, shape, device) -> torch.Tensor:
        if self.draws is not None:
            d = self.draws(kind, t, tuple(shape))
        else:
            d = default_fault_draw(self.fault_seed, kind, t, shape)
        return _to(d, device)

    def init(self, params0: dict) -> dict:
        dev = next(iter(params0.values())).device
        self._flat = _flat_template(params0)
        self._fp = device_params(self.process.params(), dev)
        stale = self.process.family == "straggler_stale"
        eps = self._draw("init", None, (self.n,), dev) if stale else None
        self.state = init_fault_state(self.process.init(eps, device=dev),
                                      params0, self.n if stale else 0)
        return self.state

    def inject(self, stacked_updates: dict, prev_params: dict, sel, avail,
               t: int) -> dict:
        """The round's corrupted stacked updates, with this injector's
        draws where the family reads them.  ``avail`` is passed through
        as given: no family reads it."""
        assert self.state is not None, "call init(params0) first"
        dev = next(iter(prev_params.values())).device
        ravel, unravel, p = self._flat
        sel = np.asarray(sel, int)
        fam = self.process.family
        noise = (self._draw("noise", t, (len(sel), p), dev)
                 if fam == "gaussian_noise" else None)
        innovations = (self._draw("innovations", t, (self.n,), dev)
                       if fam == "straggler_stale" else None)
        updf, self.state = self._step(
            self._fp, self.state, ravel(stacked_updates), ravel(prev_params),
            avail, t, torch.as_tensor(sel, dtype=torch.int64, device=dev),
            torch.ones(len(sel), dtype=torch.bool, device=dev),
            noise=noise, innovations=innovations)
        return unravel(updf)


def _to(x, device) -> torch.Tensor:
    """An array or tensor as float32 on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.to(device, torch.float32)
