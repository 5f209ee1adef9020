"""Device-native availability scenarios (the port of
``repro.core.availability_device``).

The seven Table-1 modes (``core/availability.py``) are stateless periodic
probability tables; the scenarios that stress a sampler are stateful:
Markov on/off churn, regional outages, non-stationary drift and
deadline-dropped stragglers.  An :class:`AvailabilityProcess` is

    ``init(draw) -> state``                         (the carried state)
    ``draw(state, draws, t) -> (avail bool (N,), state)``

where ``draw`` = the family's probability ``step`` (which consumes the
transition draw) followed by the shared Bernoulli + force-one-active draw
(:func:`bernoulli_nonempty`).  The scan engine (``fed/scan_engine.py``)
carries the state from round to round; the host face
(``core/availability.ProcessMode``) replays it for ``FLEngine``.

  ======== ======================= ========================================
  family   class                   p_k(t)
  ======== ======================= ========================================
  table    TableProcess            table[t % P, k]   (the Table-1 modes)
  markov   GilbertElliott          table[t % P, k] * (p_good if chain k on
                                   else p_bad); per-client 2-state chain
  cluster  ClusterOutage           table[t % P, k] * (1 if region c(k) up
                                   else floor); per-region 2-state chain
  drift    DriftProcess            (1-w(t)) A[t % P, k] + w(t) B[t % P, k]
  deadline DeadlineProcess         table[t % P, k] * 1[l_k(t) <= deadline];
                                   l_k an AR(1) log-latency state
  ======== ======================= ========================================

The family steps and :func:`proc_step` / :func:`proc_draw` are plain tensor
functions over a LEADING CELL AXIS: params and state of C cells of one
family stacked along dim 0 (:func:`stack_params`), one call for the group.
The family is host data, so the dispatch is a Python lookup (the
reference's ``lax.switch``).

RNG seam.  The reference draws from threefry keys, which torch cannot
replay: per round ``akey = fold_in(avail_key, t)`` gives the Bernoulli
uniforms (``akey``), the force-one index (``fold_in(akey, 1)``) and the
transition draw (``fold_in(akey, 2)``); ``init`` reads the raw key.  Here
every draw is a tensor handed in: ``{"u" (C, N), "force" (C,), "step" (C, N)
or None}`` per round and an (N,) init draw.  :func:`round_draws` /
:func:`init_draw` make them from a ``draws(kind, t, shape)`` callable (the
parity tests pass the reference's numbers) or, by default, from a
``torch.Generator`` on the target device seeded from
``SeedSequence([avail_seed, t])`` (``[avail_seed]`` for init), consumed in
the order u, force, step.  The transition and init draws are uniform for
``markov`` / ``cluster`` and standard normal for ``deadline``
(``draw_dist``); ``table`` and ``drift`` read none.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device

FAMILIES = ("table", "markov", "cluster", "drift", "deadline")
ALL_SCENARIOS = ("GE", "CLUSTER", "DRIFT", "DEADLINE")   # make_process names

THETA_DIM = 6          # packed per-family scalar knobs (see the _step_*)
# the distribution of each family's transition and init draws
DRAW_DIST = {"table": None, "markov": "uniform", "cluster": "uniform",
             "drift": None, "deadline": "normal"}


# ----------------------------------------------------- shared draw helpers
def ensure_nonempty(avail: torch.Tensor, forced: torch.Tensor) -> torch.Tensor:
    """Force >= 1 active client per row: where a row of ``avail`` (..., N)
    is empty, turn on client ``forced`` (...) — the rule the numpy face
    (:func:`ensure_nonempty_np`) shares.  No host sync."""
    n = avail.shape[-1]
    hit = torch.arange(n, device=avail.device) == forced[..., None]
    return avail | (hit & ~avail.any(-1, keepdim=True))


def bernoulli_nonempty(u: torch.Tensor, p: torch.Tensor,
                       forced: torch.Tensor) -> torch.Tensor:
    """Bernoulli(p) availability from uniforms ``u`` (``u < p``), with the
    force-one floor."""
    return ensure_nonempty(u < p, forced)


def ensure_nonempty_np(avail: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Host-side force-one: if the mask is empty, turn on one uniformly
    drawn client.  ``rng.integers`` is consumed ONLY when the mask is empty
    — bit-parity with the reference's ``AvailabilityMode.sample``."""
    if not avail.any():
        avail = avail.copy()
        avail[int(rng.integers(len(avail)))] = True
    return avail


def sample_bernoulli_np(p: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Host-side Bernoulli + force-one — the draw ``AvailabilityMode.sample``
    and ``ProcessMode.sample`` both delegate to."""
    return ensure_nonempty_np(rng.random(p.shape) < p, rng)


def stream_generator(entropy, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``SeedSequence(
    entropy)``: the port's per-round default streams (seeding is host work
    only, so a draw from it never syncs)."""
    state = np.random.SeedSequence(list(entropy)).generate_state(1)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


def _as_tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x)).to(device=device, dtype=dtype)


def init_draw(dist: Optional[str], n: int, avail_seed: int, device, *,
              draws: Optional[Callable] = None) -> Optional[torch.Tensor]:
    """The (N,) init draw of a family whose draws follow ``dist``
    ("uniform", "normal" or None for none): ``draws("init", None, (n,))``
    or the default stream ``SeedSequence([avail_seed])``."""
    if dist is None:
        return None
    if draws is not None:
        return _as_tensor(draws("init", None, (n,)), torch.float32, device)
    gen = stream_generator((avail_seed,), device)
    fn = torch.rand if dist == "uniform" else torch.randn
    return fn(n, generator=gen, device=device, dtype=torch.float32)


def round_draws(dist: Optional[str], n: int, avail_seed: int, t: int, device,
                *, draws: Optional[Callable] = None) -> dict:
    """One round's draws of one cell: ``{"u" (N,), "force" () int64,
    "step" (N,) or None}``, from ``draws(kind, t, shape)`` or the default
    stream ``SeedSequence([avail_seed, t])`` (consumed u, force, step)."""
    if draws is not None:
        return {"u": _as_tensor(draws("u", t, (n,)), torch.float32, device),
                "force": _as_tensor(draws("force", t, ()), torch.int64,
                                    device),
                "step": None if dist is None else _as_tensor(
                    draws("step", t, (n,)), torch.float32, device)}
    gen = stream_generator((avail_seed, t), device)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    force = torch.randint(n, (), generator=gen, device=device)
    step = None
    if dist is not None:
        fn = torch.rand if dist == "uniform" else torch.randn
        step = fn(n, generator=gen, device=device, dtype=torch.float32)
    return {"u": u, "force": force, "step": step}


def stack_draws(rows: list[dict]) -> dict:
    """Per-cell :func:`round_draws` -> the group's (C, ...) draws."""
    out = {"u": torch.stack([r["u"] for r in rows]),
           "force": torch.stack([r["force"] for r in rows])}
    out["step"] = (None if rows[0]["step"] is None else
                   torch.stack([r["step"] for r in rows]))
    return out


# ------------------------------------------------------- per-family steps
# Each: (params (C, ...), state (C, N), draw (C, N) or None, t) ->
# (p (C, N) float32, new state).  Scalars cross as 0-dim or (C, 1) tensors:
# a Python divisor would turn a division into a multiply by its reciprocal.
def _rows(params: dict, key: str, t: int) -> torch.Tensor:
    tab = params[key]
    cells = torch.arange(tab.shape[0], device=tab.device)
    return tab[cells, torch.remainder(t, params["period"])]


def _step_table(params, state, draw, t):
    return _rows(params, "table", t), state


def _flip(on: torch.Tensor, u: torch.Tensor, p_fail: torch.Tensor,
          p_recover: torch.Tensor) -> torch.Tensor:
    return torch.where(on, u >= p_fail, u < p_recover)


def _step_markov(params, state, draw, t):
    th = params["theta"]
    on = _flip(state["onoff"] > 0.5, draw, th[:, 0:1], th[:, 1:2])
    p = _rows(params, "table", t) * torch.where(on, th[:, 2:3], th[:, 3:4])
    return p, {**state, "onoff": on.to(torch.float32)}


def _step_cluster(params, state, draw, t):
    th = params["theta"]
    up = _flip(state["onoff"] > 0.5, draw, th[:, 0:1], th[:, 1:2])
    gate = torch.where(torch.gather(up, 1, params["cluster"]),
                       torch.ones_like(draw), th[:, 2:3])
    return _rows(params, "table", t) * gate, {
        **state, "onoff": up.to(torch.float32)}


def _step_drift(params, state, draw, t):
    th = params["theta"]
    t0, t1, sw = th[:, 0], th[:, 1], th[:, 2]
    tf = torch.full_like(t0, float(t))
    one = torch.ones_like(t0)
    w_ramp = torch.clamp((tf - t0) / torch.maximum(t1 - t0, one), 0.0, 1.0)
    w_switch = torch.remainder(torch.floor(tf / torch.maximum(sw, one)), 2.0)
    w = torch.where(sw > 0, w_switch, w_ramp)[:, None]
    p = (1.0 - w) * _rows(params, "table", t) + w * _rows(params, "table_b", t)
    return p, state


def _step_deadline(params, state, draw, t):
    th = params["theta"]
    rho, sigma, deadline = th[:, 0:1], th[:, 1:2], th[:, 2:3]
    lat = rho * state["latency"] + (1.0 - rho) * params["aux"] + sigma * draw
    p = _rows(params, "table", t) * (lat <= deadline).to(torch.float32)
    return p, {**state, "latency": lat}


_STEPS = {"table": _step_table, "markov": _step_markov,
          "cluster": _step_cluster, "drift": _step_drift,
          "deadline": _step_deadline}


def proc_step(params: dict, state: dict, draw: Optional[torch.Tensor],
              t: int):
    """Per-round availability probabilities of a group of cells of ONE
    family (``params["family"]``): ``draw`` is the (C, N) transition draw
    (None for the stateless families).  Returns ``(p (C, N) f32, new
    state)``."""
    return _STEPS[FAMILIES[params["family"]]](params, state, draw, int(t))


def proc_draw(params: dict, state: dict, draws: dict, t: int):
    """The full per-round draw of a group: family step, then the shared
    Bernoulli + force-one.  Returns ``(avail (C, N) bool, new state)``."""
    p, state = proc_step(params, state, draws["step"], t)
    return bernoulli_nonempty(draws["u"], p, draws["force"]), state


def stack_params(params: list[dict], device=None) -> dict:
    """Processes' :meth:`AvailabilityProcess.params` -> one stacked (C, ...)
    params dict on ``device`` (default: where they lie), the tables
    zero-padded to the common period (rows past a cell's own period are
    never read: lookups are ``table[t % period]``).  ``family`` is kept
    when every entry shares it, else set to None."""
    pmax = max(int(p["table"].shape[0]) for p in params)

    def pad(tab):
        extra = pmax - tab.shape[0]
        return tab if not extra else torch.cat(
            [tab, tab.new_zeros((extra,) + tuple(tab.shape[1:]))])
    fams = {p["family"] for p in params}
    out = {"family": fams.pop() if len(fams) == 1 else None}
    for k in ("table", "table_b"):
        out[k] = torch.stack([pad(p[k]) for p in params])
    for k in ("period", "theta", "cluster", "aux"):
        out[k] = torch.stack([torch.as_tensor(p[k]) for p in params])
    if device is not None:
        out = {k: v if k == "family" else v.to(device)
               for k, v in out.items()}
    return out


def stack_state(states: list[dict]) -> dict:
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


# ------------------------------------------------------------ the processes
def _ones_table(n: int) -> np.ndarray:
    return np.ones((1, n), np.float64)


def _as_table(table, n: Optional[int] = None) -> np.ndarray:
    t = np.atleast_2d(np.asarray(table, np.float64))
    if n is not None and t.shape[1] != n:
        raise ValueError(f"table has {t.shape[1]} clients, expected {n}")
    return t


@dataclass
class AvailabilityProcess:
    """Base class.  Subclasses set ``family`` and fill the params/state
    fields they use; everything else takes neutral defaults, so every
    process has the same params and state layout.

    ``params()`` packs the cell's params (CPU tensors: the float64 source
    tables cast to float32 once, as the reference does; ``family`` the int
    index); ``init(draw)`` builds the state; ``step`` / ``draw`` run one
    round for this process alone (a group of one)."""

    family = "table"
    name = "process"

    def __post_init__(self):
        self._params = None

    @property
    def draw_dist(self) -> Optional[str]:
        return DRAW_DIST[self.family]

    # -- params -----------------------------------------------------------
    def _table(self) -> np.ndarray:
        raise NotImplementedError

    def _table_b(self) -> np.ndarray:
        return np.zeros_like(self._table())

    def _theta(self) -> np.ndarray:
        return np.zeros(THETA_DIM)

    def _cluster_ids(self) -> np.ndarray:
        return np.zeros(self.n_clients, np.int64)

    def _aux(self) -> np.ndarray:
        return np.zeros(self.n_clients)

    @property
    def n_clients(self) -> int:
        return self._table().shape[1]

    def params(self) -> dict:
        """``{"family": int, "table" (P, N) f32, "table_b" (P, N) f32,
        "period" () int64, "theta" (THETA_DIM,) f32, "cluster" (N,) int64,
        "aux" (N,) f32}`` on the CPU."""
        if self._params is None:
            table = self._table()
            theta = np.zeros(THETA_DIM, np.float32)
            th = np.asarray(self._theta(), np.float32)
            theta[:th.shape[0]] = th
            self._params = {
                "family": FAMILIES.index(self.family),
                "table": torch.from_numpy(table.astype(np.float32)),
                "table_b": torch.from_numpy(
                    self._table_b().astype(np.float32)),
                "period": torch.tensor(table.shape[0], dtype=torch.int64),
                "theta": torch.from_numpy(theta),
                "cluster": torch.from_numpy(
                    np.asarray(self._cluster_ids(), np.int64)),
                "aux": torch.from_numpy(np.asarray(self._aux(), np.float32)),
            }
        return self._params

    def init(self, draw: Optional[torch.Tensor] = None, *,
             device=None) -> dict:
        """Initial carried state on ``device`` (None means CUDA, and raises
        without it).  ``draw`` is the (N,) init draw of the families that
        read one (``draw_dist``)."""
        dev = resolve_device(device, who=f"{type(self).__name__}.init")
        n = self.n_clients
        return {"onoff": torch.ones(n, dtype=torch.float32, device=dev),
                "latency": torch.zeros(n, dtype=torch.float32, device=dev)}

    def _need(self, draw):
        if draw is None:
            raise ValueError(f"{self.family} needs its (N,) init draw")
        return draw

    # -- one process ------------------------------------------------------
    def _group(self, device) -> dict:
        return stack_params([self.params()], device)

    def step(self, state: dict, draw: Optional[torch.Tensor], t: int):
        """``(p (N,), new state)`` for this process's state (N,)."""
        dev = state["onoff"].device
        p, st = proc_step(self._group(dev), stack_state([state]),
                          None if draw is None else draw[None], t)
        return p[0], {k: v[0] for k, v in st.items()}

    def draw(self, state: dict, draws: dict, t: int):
        """``(avail (N,) bool, new state)`` from one round's draws."""
        dev = state["onoff"].device
        avail, st = proc_draw(self._group(dev), stack_state([state]),
                              stack_draws([draws]), t)
        return avail[0], {k: v[0] for k, v in st.items()}

    def host_probs(self, t: int) -> Optional[np.ndarray]:
        """Exact float64 probabilities for the STATELESS families (the host
        face serves them as they are); stateful families return None and
        the host face replays the step stream."""
        return None


@dataclass
class TableProcess(AvailabilityProcess):
    """The seven Table-1 modes: a dense periodic ``(P, N)`` probability
    table (``AvailabilityMode.probs_table()``), stateless."""
    table: np.ndarray
    name: str = "table"

    family = "table"

    def __post_init__(self):
        super().__post_init__()
        self.table = _as_table(self.table)

    def _table(self):
        return self.table

    def host_probs(self, t):
        return self.table[t % self.table.shape[0]]


@dataclass
class GilbertElliott(AvailabilityProcess):
    """Per-client Gilbert–Elliott on/off Markov chains: chain k flips
    on->off w.p. ``1/mean_on`` and off->on w.p. ``1/mean_off`` each round;
    availability is ``base * p_good`` while on, ``base * p_bad`` while off.
    Stationary participation = base * (pi_on p_good + (1-pi_on) p_bad)."""
    n: int
    mean_on: float = 8.0
    mean_off: float = 4.0
    p_good: float = 1.0
    p_bad: float = 0.0
    base_table: Optional[np.ndarray] = None
    name: str = "markov"

    family = "markov"

    def _table(self):
        return (_ones_table(self.n) if self.base_table is None
                else _as_table(self.base_table, self.n))

    def _theta(self):
        return np.array([1.0 / max(self.mean_on, 1.0),
                         1.0 / max(self.mean_off, 1.0),
                         self.p_good, self.p_bad])

    @property
    def pi_on(self) -> float:
        return self.mean_on / (self.mean_on + self.mean_off)

    def init(self, draw=None, *, device=None):
        state = super().init(device=device)
        on = self._need(draw).to(state["onoff"]) < float(np.float32(self.pi_on))
        return {**state, "onoff": on.to(torch.float32)}


@dataclass
class ClusterOutage(AvailabilityProcess):
    """Block-correlated outages: clients grouped into regions, each region
    ONE up/down Markov chain (P(up->down) = p_fail, P(down->up) =
    p_recover); a down region multiplies its clients' availability by
    ``floor``."""
    n: int
    n_clusters: int = 4
    p_fail: float = 0.1
    p_recover: float = 0.3
    floor: float = 0.05
    cluster: Optional[np.ndarray] = None    # (N,) region ids; default rr
    base_table: Optional[np.ndarray] = None
    name: str = "cluster"

    family = "cluster"

    def _table(self):
        return (_ones_table(self.n) if self.base_table is None
                else _as_table(self.base_table, self.n))

    def _theta(self):
        return np.array([self.p_fail, self.p_recover, self.floor])

    def _cluster_ids(self):
        if self.cluster is not None:
            return np.asarray(self.cluster, np.int64)
        return (np.arange(self.n) % self.n_clusters).astype(np.int64)

    @property
    def pi_up(self) -> float:
        return self.p_recover / (self.p_fail + self.p_recover)

    def init(self, draw=None, *, device=None):
        # region chains live in the first n_clusters slots of the (N,) state
        state = super().init(device=device)
        up = self._need(draw).to(state["onoff"]) < float(np.float32(self.pi_up))
        return {**state, "onoff": up.to(torch.float32)}


@dataclass
class DriftProcess(AvailabilityProcess):
    """Non-stationary drift: interpolate between periodic tables A and B —
    ``w(t) = clip((t - t0)/(t1 - t0), 0, 1)`` (ramp) or, with
    ``switch_period > 0``, the regime switch ``w(t) = (t // T_sw) % 2``.
    Stateless but aperiodic."""
    table_a: np.ndarray
    table_b: np.ndarray
    t0: float = 0.0
    t1: float = 100.0
    switch_period: int = 0
    name: str = "drift"

    family = "drift"

    def __post_init__(self):
        super().__post_init__()
        a, b = _as_table(self.table_a), _as_table(self.table_b)
        if a.shape[1] != b.shape[1]:
            raise ValueError("table_a / table_b client counts differ")
        # tile both to the common (lcm) period so one row index serves both
        p = int(np.lcm(a.shape[0], b.shape[0]))
        self.table_a = np.tile(a, (p // a.shape[0], 1))
        self.table_b = np.tile(b, (p // b.shape[0], 1))

    def _table(self):
        return self.table_a

    def _table_b(self):
        return self.table_b

    def _theta(self):
        return np.array([self.t0, self.t1, float(self.switch_period)])

    def weight(self, t: int) -> float:
        if self.switch_period > 0:
            return float((t // self.switch_period) % 2)
        return float(np.clip((t - self.t0) / max(self.t1 - self.t0, 1.0),
                             0.0, 1.0))

    def host_probs(self, t):
        w = self.weight(t)
        row = t % self.table_a.shape[0]
        return (1.0 - w) * self.table_a[row] + w * self.table_b[row]


@dataclass
class DeadlineProcess(AvailabilityProcess):
    """Deadline-constrained participation: client k carries an AR(1)
    latency ``l' = rho l + (1 - rho) mu_k + sigma eps`` and is dropped
    whenever ``l' > deadline``.  Stationarily ``l_k ~ N(mu_k, sigma² / (1 -
    rho²))``, so the participation rate is ``base_k * Phi((deadline -
    mu_k) / sd)``."""
    n: int
    deadline: float = 1.0
    rho: float = 0.8
    sigma: float = 0.2
    mu: Optional[np.ndarray] = None      # (N,) mean latencies; default U[.5, 1.5]
    base_table: Optional[np.ndarray] = None
    mu_seed: int = 0
    name: str = "deadline"

    family = "deadline"

    def _table(self):
        return (_ones_table(self.n) if self.base_table is None
                else _as_table(self.base_table, self.n))

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

    def stationary_rate(self) -> np.ndarray:
        """Analytic per-client participation probability (base x Phi), the
        normal CDF in float64; the reference evaluates it in float32, and
        the two differ by at most 7.2e-8 (N = 80, deadlines 0.7–1.3, five
        mu seeds)."""
        z = (self.deadline - self._mu()) / max(self.stationary_sd, 1e-12)
        phi = np.array([0.5 * math.erfc(-zz / math.sqrt(2.0)) for zz in z])
        return self._table().mean(0) * phi

    def init(self, draw=None, *, device=None):
        state = super().init(device=device)
        mu = torch.from_numpy(self._mu().astype(np.float32)).to(
            state["latency"].device)
        sd = float(np.float32(self.stationary_sd))
        return {**state, "latency": mu + sd * self._need(draw).to(mu)}


# ------------------------------------------------------------------ factory
def make_process(name: str, *, n_clients: int, data_sizes=None,
                 label_sets=None, num_labels: int = 10,
                 beta: Optional[float] = None, seed: int = 0,
                 period: int = 20, rounds: int = 100,
                 **kw) -> AvailabilityProcess:
    """Scenario names -> processes.  The seven Table-1 mode names build a
    :class:`TableProcess` (via ``core.availability.make_mode``); the
    stateful families:

      GE        per-client Gilbert–Elliott chains (kw: mean_on, mean_off, …)
      CLUSTER   regional-outage chains           (kw: n_clusters, p_fail, …)
      DRIFT     MDF -> LDF ramp over ``rounds`` (a 0.9 -> 0.25 flat ramp
                without data_sizes; kw override all)
      DEADLINE  AR(1) straggler latencies        (kw: deadline, rho, sigma)
    """
    uname = name.upper()
    if uname == "GE":
        return GilbertElliott(n_clients, **kw)
    if uname == "CLUSTER":
        kw.setdefault("n_clusters", max(2, n_clients // 10))
        return ClusterOutage(n_clients, **kw)
    if uname == "DRIFT":
        if "table_a" not in kw:
            from repro_torch.core.availability import make_mode
            if data_sizes is not None:
                kw["table_a"] = make_mode(
                    "MDF", n_clients=n_clients,
                    data_sizes=data_sizes).probs_table()
                kw["table_b"] = make_mode(
                    "LDF", n_clients=n_clients,
                    data_sizes=data_sizes).probs_table()
            else:
                kw["table_a"] = np.full((1, n_clients), 0.9)
                kw["table_b"] = np.full((1, n_clients), 0.25)
        kw.setdefault("t0", 0.0)
        kw.setdefault("t1", float(rounds))
        return DriftProcess(**kw)
    if uname == "DEADLINE":
        kw.setdefault("mu_seed", seed)
        return DeadlineProcess(n_clients, **kw)
    from repro_torch.core.availability import make_mode
    return make_mode(name, n_clients=n_clients, data_sizes=data_sizes,
                     label_sets=label_sets, num_labels=num_labels, beta=beta,
                     seed=seed, period=period).process()


# ------------------------------------------------------------- trace utility
def device_trace(process: AvailabilityProcess, rounds: int,
                 avail_seed: int = 1234, *, draws: Optional[Callable] = None,
                 device=None) -> np.ndarray:
    """(rounds, N) bool availability trace drawn on ``device`` (None means
    CUDA) with the scan engine's draws: ``draws(kind, t, shape)`` or the
    default streams of ``avail_seed``."""
    dev = resolve_device(device, who="device_trace")
    n, dist = process.n_clients, process.draw_dist
    params = stack_params([process.params()], dev)
    state = stack_state([process.init(
        init_draw(dist, n, avail_seed, dev, draws=draws), device=dev)])
    out = []
    for t in range(rounds):
        d = stack_draws([round_draws(dist, n, avail_seed, t, dev,
                                     draws=draws)])
        avail, state = proc_draw(params, state, d, t)
        out.append(avail[0])
    return torch.stack(out).cpu().numpy()
