"""The paper's seven client-availability modes (Table 1) — numpy.

A copy of ``repro.core.availability``'s mode classes and host draw (the
numpy Bernoulli helpers they delegate to live in ``availability_device``).
The masks are numpy draws, so the port's masks are BITWISE equal to the
reference's for the same seeds.  Each mode is also a device process
(:meth:`AvailabilityMode.process`, a ``TableProcess``), and
:class:`ProcessMode` is the host face over any process, so ``FLEngine``
runs the stateful scenario families too.

Each mode yields a per-client active probability ``p_k(t)``; each round the
active set is an independent Bernoulli draw with a *dedicated* seed stream
(independent of model-training randomness, as in Appendix C, so all methods
see identical availability traces).

Mode table (paper Table 1 rows -> formulas; beta defaults in parentheses):

  ====  =============================  ==========================================
  name  Table 1 row                    p_k(t)
  ====  =============================  ==========================================
  IDL   Ideal                          1
  MDF   More-Data-First (beta=0.7)     n_k^beta / max_i n_i^beta
  LDF   Less-Data-First (beta=0.7)     n_k^-beta / max_i n_i^-beta
  YMF   Y-Max-First (beta=0.9)         beta * min_i{y_ki} / max_{c,j}{y_cj}
                                         + (1 - beta)            (Gu et al. 2021)
  YC    Y-Cycle (beta=0.9, T_p=20)     beta * 1[exists y in Y_k:
                                         y/C <= phase(t) < (y+1)/C] + (1 - beta),
                                         phase(t) = (1 + t mod T_p) / T_p
                                         (last band closed at phase = 1.0,
                                          hit at t = T_p - 1)
  LN    Log-Normal (beta=0.5)          c_k / max_i c_i,
                                         c ~ LogNormal(0, ln 1/(1-beta))
  SLN   Sin-Log-Normal (beta=0.5;      clip(p_k^LN * (0.4 sin(2 pi
          T_p=20 via make_mode,          (1 + t mod T_p)/T_p) + 0.5), 0, 1)
          24 if built directly)
  ====  =============================  ==========================================
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.availability_device import (
    AvailabilityProcess, TableProcess, init_draw, round_draws,
    sample_bernoulli_np,
)


class AvailabilityMode:
    """Base class.  Subclasses implement ``_row(t)`` (the ``p_k(t)`` formula,
    which must only depend on ``t % period``) and set ``period``; the base
    class materializes the dense ``(period, N)`` probability table once and
    serves the numpy API from it."""

    name = "base"
    period: int = 1

    def _row(self, t: int) -> np.ndarray:
        raise NotImplementedError

    def probs_table(self) -> np.ndarray:
        """The full periodic schedule as a pure ``(period, N)`` float array:
        ``p(t) = probs_table()[t % period]``."""
        if not hasattr(self, "_table"):
            self._table = np.stack(
                [np.asarray(self._row(t), np.float64)
                 for t in range(self.period)])
        return self._table

    def probs(self, t: int) -> np.ndarray:
        """Per-client active probabilities for round t (numpy wrapper)."""
        return self.probs_table()[t % self.period]

    def sample(self, t: int, rng: np.random.Generator) -> np.ndarray:
        """Boolean active mask for round t — the shared Bernoulli +
        force-one-active draw (:func:`sample_bernoulli_np`)."""
        return sample_bernoulli_np(self.probs(t), rng)

    def process(self) -> TableProcess:
        """This mode as a device-native ``AvailabilityProcess`` (the f64
        table stays on the process for the host face; the device params
        cast it to float32)."""
        if not hasattr(self, "_process"):
            self._process = TableProcess(self.probs_table(), name=self.name)
        return self._process


class Ideal(AvailabilityMode):
    """Full client availability."""
    name = "IDL"

    def __init__(self, n_clients: int):
        self.n = n_clients

    def _row(self, t):
        return np.ones(self.n)


class MoreDataFirst(AvailabilityMode):
    """p_k = n_k^beta / max_i n_i^beta."""
    name = "MDF"

    def __init__(self, data_sizes, beta: float = 0.7):
        ns = np.asarray(data_sizes, float)
        self.p = ns ** beta / np.max(ns ** beta)

    def _row(self, t):
        return self.p


class LessDataFirst(AvailabilityMode):
    """p_k = n_k^-beta / max_i n_i^-beta."""
    name = "LDF"

    def __init__(self, data_sizes, beta: float = 0.7):
        ns = np.asarray(data_sizes, float)
        inv = ns ** (-beta)
        self.p = inv / np.max(inv)

    def _row(self, t):
        return self.p


class YMaxFirst(AvailabilityMode):
    """p_k = beta * min_i{y_ki} / max_{c,j}{y_cj} + (1 - beta).  (Gu et al. 2021)"""
    name = "YMF"

    def __init__(self, label_sets: list[set[int]], beta: float = 0.9):
        gmax = max(max(s) for s in label_sets)
        self.p = np.array([beta * min(s) / max(gmax, 1) + (1 - beta) for s in label_sets])

    def _row(self, t):
        return self.p


class YCycle(AvailabilityMode):
    """Periodic availability keyed on label values (ours/Table 1)."""
    name = "YC"

    def __init__(self, label_sets: list[set[int]], num_labels: int,
                 beta: float = 0.9, period: int = 20):
        self.label_sets = label_sets
        self.num_y = num_labels
        self.beta = beta
        self.tp = period
        self.period = period

    def _row(self, t):
        phase = (1 + (t % self.tp)) / self.tp
        out = np.empty(len(self.label_sets))
        for k, s in enumerate(self.label_sets):
            # label bands are half-open [y/C, (y+1)/C) except the LAST band,
            # which closes at 1.0: phase hits exactly 1.0 at t = T_p - 1, and
            # an all-open top band would match no label there, silently
            # dropping every client to the 1 - beta floor once per cycle
            hit = any(y / self.num_y <= phase
                      and (phase < (y + 1) / self.num_y or y + 1 == self.num_y)
                      for y in s)
            out[k] = self.beta * float(hit) + (1 - self.beta)
        return out


class LogNormal(AvailabilityMode):
    """Static availability c_k ~ lognormal(0, ln 1/(1-beta)); p = c/max c."""
    name = "LN"

    def __init__(self, n_clients: int, beta: float = 0.5, seed: int = 0):
        rng = np.random.default_rng(seed)
        sigma = np.log(1.0 / (1.0 - beta))
        c = rng.lognormal(0.0, sigma, n_clients)
        self.p = c / c.max()

    def _row(self, t):
        return self.p


class SinLogNormal(LogNormal):
    """Sin-modulated lognormal availability."""
    name = "SLN"

    def __init__(self, n_clients: int, beta: float = 0.5, seed: int = 0,
                 period: int = 24):
        super().__init__(n_clients, beta, seed)
        self.tp = period
        self.period = period

    def _row(self, t):
        mod = 0.4 * np.sin(2 * np.pi * (1 + (t % self.tp)) / self.tp) + 0.5
        return np.clip(self.p * mod, 0.0, 1.0)


def make_mode(name: str, *, n_clients: int, data_sizes=None, label_sets=None,
              num_labels: int = 10, beta: float | None = None,
              seed: int = 0, period: int = 20) -> AvailabilityMode:
    """Factory used by benchmarks/launchers: mode names as in the paper."""
    name = name.upper()
    if name == "IDL":
        return Ideal(n_clients)
    if name == "MDF":
        return MoreDataFirst(data_sizes, beta if beta is not None else 0.7)
    if name == "LDF":
        return LessDataFirst(data_sizes, beta if beta is not None else 0.7)
    if name == "YMF":
        return YMaxFirst(label_sets, beta if beta is not None else 0.9)
    if name == "YC":
        return YCycle(label_sets, num_labels, beta if beta is not None else 0.9, period)
    if name == "LN":
        return LogNormal(n_clients, beta if beta is not None else 0.5, seed)
    if name == "SLN":
        return SinLogNormal(n_clients, beta if beta is not None else 0.5, seed, period)
    raise ValueError(f"unknown availability mode {name!r}")


ALL_MODES = ("IDL", "MDF", "LDF", "YMF", "YC", "LN", "SLN")


# ----------------------------------------------------------- host face
class ProcessMode:
    """Numpy face over ANY ``AvailabilityProcess`` — the ``probs(t)`` /
    ``sample(t, rng)`` API ``FLEngine`` and ``precompute_masks`` consume.

    Stateless families (table, drift) serve exact float64 probabilities
    (``process.host_probs``).  Stateful families replay the process on the
    CPU from ``avail_seed``: the init and transition draws are the port's
    own default streams, the ones a CPU scan cell with this ``avail_seed``
    draws (so the latent chain is that cell's), or ``draws(kind, t,
    shape)`` when given ("init" and "step", as the scan engine's seam).
    Only the Bernoulli differs from the scan: numpy here.  Rows are cached,
    so replay is deterministic and order-independent."""

    def __init__(self, process: AvailabilityProcess, avail_seed: int = 1234,
                 *, draws=None):
        self.process = process
        self.name = getattr(process, "name", process.family)
        self.avail_seed = avail_seed        # host_draw checks it matches
        self._draws = draws
        self._state = None
        self._rows: list[np.ndarray] = []

    def probs(self, t: int) -> np.ndarray:
        hp = self.process.host_probs(t)
        if hp is not None:
            return np.asarray(hp, np.float64)
        proc, n = self.process, self.process.n_clients
        if self._state is None:
            self._state = proc.init(init_draw(
                proc.draw_dist, n, self.avail_seed, "cpu",
                draws=self._draws), device="cpu")
        while len(self._rows) <= t:
            tt = len(self._rows)
            d = round_draws(proc.draw_dist, n, self.avail_seed, tt, "cpu",
                            draws=self._draws)
            p, self._state = proc.step(self._state, d["step"], tt)
            self._rows.append(p.numpy().astype(np.float64))
        return self._rows[t]

    def sample(self, t: int, rng: np.random.Generator) -> np.ndarray:
        return sample_bernoulli_np(self.probs(t), rng)


def host_round_rng(avail_seed: int, t: int) -> np.random.Generator:
    """The per-round numpy availability stream — ``SeedSequence([seed, t])``,
    independent of model-training randomness (Appendix C)."""
    return np.random.default_rng(np.random.SeedSequence([avail_seed, t]))


def host_draw(mode, t: int, avail_seed: int = 1234) -> np.ndarray:
    """ONE round's host-side availability mask — the wrapper ``FLEngine.run``
    and ``scan_engine.precompute_masks`` call.  ``mode`` is anything with
    ``sample(t, rng)``: an ``AvailabilityMode`` or a ``ProcessMode``.

    A ``ProcessMode`` bakes its latent-stream seed at construction; drawing
    it under another Bernoulli seed would give a trace that matches neither
    scan run, so a mismatch is an error, not a silent skew."""
    mode_seed = getattr(mode, "avail_seed", None)
    if mode_seed is not None and mode_seed != avail_seed:
        raise ValueError(
            f"availability seed mismatch: the ProcessMode was built with "
            f"avail_seed={mode_seed} but host_draw was asked for "
            f"avail_seed={avail_seed}; the latent process stream and the "
            f"Bernoulli stream must share one seed for host<->scan parity")
    return mode.sample(t, host_round_rng(avail_seed, t))


def host_trace(mode, rounds: int, avail_seed: int = 1234) -> np.ndarray:
    """(rounds, N) bool availability trace via :func:`host_draw`."""
    return np.stack([host_draw(mode, t, avail_seed) for t in range(rounds)])
