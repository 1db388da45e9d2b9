"""Polytune's search managers, an own copy of `polyaxon_tpu/tuner/managers.py`:
a matrix spec → suggestion batches. Grid, random, mapping, iterative,
hyperband (bracket math), ASHA, bayes (a GP with UCB/EI/PI, TuRBO trust
regions, BAxUS subspaces) and hyperopt (TPE). All numpy and seeded: for the
same matrix and the same observed scores they give the JAX package's
suggestions bit for bit.

The protocol is iteration-based:
    mgr = build_manager(matrix)
    while not mgr.done:
        batch = mgr.suggest()                      # list[Suggestion]
        ... run them, collect metric per trial ...
        mgr.observe([(suggestion, metric), ...])
Suggestions carry the param dict plus bookkeeping (bracket/rung for
hyperband, the resource budget to inject).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np

from ..schemas.matrix import (
    V1Asha,
    V1Bayes,
    V1GridSearch,
    V1Hyperband,
    V1Hyperopt,
    V1Iterative,
    V1Mapping,
    V1Matrix,
    V1RandomSearch,
)
from .space import (
    from_unit,
    grid_configs,
    param_bounds,
    sample_config,
    to_unit,
)


@dataclasses.dataclass
class Suggestion:
    params: dict[str, Any]
    # hyperband bookkeeping; None elsewhere
    bracket: Optional[int] = None
    rung: Optional[int] = None
    resource: Optional[float] = None

    def run_params(self) -> dict[str, Any]:
        return dict(self.params)


class SearchManager:
    matrix: V1Matrix

    @property
    def done(self) -> bool:
        raise NotImplementedError

    def suggest(self) -> list[Suggestion]:
        raise NotImplementedError

    def observe(self, results: list[tuple[Suggestion, Optional[float]]]) -> None:
        """results: (suggestion, objective) — objective already sign-fixed so
        HIGHER IS BETTER; None = trial failed."""


class GridSearchManager(SearchManager):
    def __init__(self, matrix: V1GridSearch):
        self.matrix = matrix
        configs = grid_configs(matrix.params)
        if matrix.num_runs:
            configs = configs[: matrix.num_runs]
        self._batch = [Suggestion(params=c) for c in configs]
        self._served = False

    @property
    def done(self) -> bool:
        return self._served

    def suggest(self) -> list[Suggestion]:
        self._served = True
        return list(self._batch)


class RandomSearchManager(SearchManager):
    def __init__(self, matrix: V1RandomSearch):
        self.matrix = matrix
        self._served = False
        self._rng = np.random.default_rng(matrix.seed or 0)

    @property
    def done(self) -> bool:
        return self._served

    def suggest(self) -> list[Suggestion]:
        self._served = True
        return [
            Suggestion(params=sample_config(self.matrix.params, self._rng))
            for _ in range(self.matrix.num_runs)
        ]


class MappingManager(SearchManager):
    def __init__(self, matrix: V1Mapping):
        self.matrix = matrix
        self._served = False

    @property
    def done(self) -> bool:
        return self._served

    def suggest(self) -> list[Suggestion]:
        self._served = True
        return [Suggestion(params=dict(v)) for v in self.matrix.values]


class HyperbandManager(SearchManager):
    """Li et al. Hyperband. R = max_iterations (max resource per config),
    eta = downsampling. Brackets s = s_max..0; bracket s starts with
    n = ceil((s_max+1)/(s+1) * eta^s) configs at resource r = R * eta^-s,
    and successive-halves keeping top 1/eta per rung.

    Suggestion flow: one `suggest()` call per rung; `observe()` feeds that
    rung's objectives back, the manager promotes the top performers into the
    next rung (same bracket), then moves to the next bracket."""

    def __init__(self, matrix: V1Hyperband):
        self.matrix = matrix
        self._rng = np.random.default_rng(matrix.seed or 0)
        self.R = float(matrix.max_iterations)
        self.eta = float(matrix.eta)
        self.s_max = int(math.floor(math.log(self.R) / math.log(self.eta)))
        self._brackets = list(range(self.s_max, -1, -1))
        self._bracket_idx = 0
        self._rung = 0
        self._pending: Optional[list[Suggestion]] = None  # current rung configs
        self._promoted: Optional[list[dict]] = None

    # bracket geometry -------------------------------------------------
    def bracket_n(self, s: int) -> int:
        return int(math.ceil((self.s_max + 1) / (s + 1) * self.eta**s))

    def bracket_r(self, s: int) -> float:
        return self.R * self.eta**-s

    def rung_n(self, s: int, i: int) -> int:
        return int(math.floor(self.bracket_n(s) * self.eta**-i))

    def rung_r(self, s: int, i: int) -> float:
        r = self.bracket_r(s) * self.eta**i
        if self.matrix.resource.type == "int":
            return float(int(round(r)))
        return r

    @property
    def done(self) -> bool:
        return self._bracket_idx >= len(self._brackets)

    def suggest(self) -> list[Suggestion]:
        s = self._brackets[self._bracket_idx]
        i = self._rung
        n_i = self.rung_n(s, i)
        r_i = self.rung_r(s, i)
        if i == 0:
            configs = [
                sample_config(self.matrix.params, self._rng) for _ in range(n_i)
            ]
        else:
            configs = self._promoted[:n_i]
        self._pending = [
            Suggestion(params=c, bracket=s, rung=i, resource=r_i) for c in configs
        ]
        return list(self._pending)

    def observe(self, results):
        s = self._brackets[self._bracket_idx]
        scored = [(sug, obj) for sug, obj in results if obj is not None]
        scored.sort(key=lambda t: t[1], reverse=True)
        keep = self.rung_n(s, self._rung + 1)
        self._promoted = [sug.params for sug, _ in scored[:keep]]
        # advance: next rung while it holds >=1 config AND something was
        # promoted into it (an all-failed rung abandons this bracket only —
        # later brackets run at higher resource and may well succeed)
        if (
            self._promoted
            and self._rung + 1 <= s
            and self.rung_n(s, self._rung + 1) >= 1
        ):
            self._rung += 1
        else:
            self._bracket_idx += 1
            self._rung = 0
            self._promoted = None


class AshaManager(SearchManager):
    """ASHA — asynchronous successive halving (Li et al. 2020, MLSys).

    Hyperband's rung is a BARRIER: every config in the rung must finish
    before any promotion. ASHA promotes per-completion: after each observe,
    any config in the top 1/eta of its rung's finished trials that hasn't
    been promoted advances to the next rung at eta x the resource. With
    concurrent trials this keeps every device busy — stragglers and
    failures never stall the sweep, which is what parallel trials on
    disjoint device groups want (tuner/placement.py).

    Rung i resource: min_resource * eta^i, capped at max_resource (top
    rung). Budget: `max_iterations` total trial executions across rungs.
    """

    def __init__(self, matrix: V1Asha):
        self.matrix = matrix
        self._rng = np.random.default_rng(matrix.seed or 0)
        self.eta = float(matrix.eta)
        self.r_min = float(matrix.min_resource)
        self.r_max = float(matrix.max_resource)
        # +1e-9: float log error must not drop the top rung (e.g.
        # log(1000)/log(10) == 2.9999999999999996 would lose resource 1000)
        self.n_rungs = (
            int(
                math.floor(
                    math.log(self.r_max / self.r_min) / math.log(self.eta) + 1e-9
                )
            )
            + 1
        )
        # rung i → list of (key, score); key identifies a config across rungs
        self._rungs: list[list[tuple[int, float]]] = [
            [] for _ in range(self.n_rungs)
        ]
        self._configs: dict[int, dict] = {}
        self._promoted: set[tuple[int, int]] = set()  # (rung, key)
        self._started = 0
        self._next_key = 0

    def _resource(self, rung: int) -> float:
        r = min(self.r_min * self.eta**rung, self.r_max)
        if self.matrix.resource.type == "int":
            return float(int(round(r)))
        return r

    @property
    def done(self) -> bool:
        return self._started >= int(self.matrix.max_iterations)

    def _promotable(self) -> Optional[tuple[int, int]]:
        """(rung, key) of the best unpromoted top-1/eta config, scanning
        from the highest rung down (finish strong candidates first)."""
        for i in range(self.n_rungs - 2, -1, -1):
            finished = sorted(self._rungs[i], key=lambda t: t[1], reverse=True)
            k = int(len(finished) / self.eta)
            for key, _ in finished[:k]:
                if (i, key) not in self._promoted:
                    return i, key
        return None

    def suggest(self) -> list[Suggestion]:
        batch = []
        width = max(1, int(self.matrix.concurrency or 1))
        budget = int(self.matrix.max_iterations) - self._started
        for _ in range(min(width, budget)):
            promo = self._promotable()
            if promo is not None:
                rung, key = promo
                self._promoted.add((rung, key))
                sug = Suggestion(
                    params=dict(self._configs[key]),
                    bracket=key,  # bracket slot carries the config key
                    rung=rung + 1,
                    resource=self._resource(rung + 1),
                )
            else:
                key = self._next_key
                self._next_key += 1
                self._configs[key] = sample_config(self.matrix.params, self._rng)
                sug = Suggestion(
                    params=dict(self._configs[key]),
                    bracket=key,
                    rung=0,
                    resource=self._resource(0),
                )
            self._started += 1
            batch.append(sug)
        return batch

    def observe(self, results):
        for sug, obj in results:
            if obj is None:
                continue  # failed trial: never promotable, budget spent
            self._rungs[int(sug.rung)].append((int(sug.bracket), float(obj)))

    def best_rung_table(self) -> list[dict]:
        """Introspection for tests/UI: per-rung counts and resources."""
        return [
            {
                "rung": i,
                "resource": self._resource(i),
                "finished": len(self._rungs[i]),
            }
            for i in range(self.n_rungs)
        ]


class BayesSearchManager(SearchManager):
    """GP (RBF kernel, unit-cube encoding) + UCB/EI/PI acquisition maximized
    over seeded random candidates. num_initial_runs random warmup points,
    then max_iterations suggestions of one point each."""

    def __init__(self, matrix: V1Bayes):
        self.matrix = matrix
        self._rng = np.random.default_rng(matrix.seed or 0)
        self._names = sorted(matrix.params)
        self._X: list[list[float]] = []  # unit-cube encodings
        self._y: list[float] = []
        self._iteration = 0
        util = dict(matrix.utility_function or {})
        self._acq = str(
            util.get("acquisition_function", util.get("acquisitionFunction", "ucb"))
        )
        self._kappa = float(util.get("kappa", 2.576))
        self._eps = float(util.get("eps", 0.0))

    @property
    def done(self) -> bool:
        return self._iteration >= self.matrix.max_iterations + 1

    def _encode(self, cfg: dict) -> list[float]:
        return [to_unit(self.matrix.params[n], cfg[n]) for n in self._names]

    def _decode(self, u: np.ndarray) -> dict:
        return {
            n: from_unit(self.matrix.params[n], float(u[i]))
            for i, n in enumerate(self._names)
        }

    def suggest(self) -> list[Suggestion]:
        if self._iteration == 0:  # warmup batch
            return [
                Suggestion(params=sample_config(self.matrix.params, self._rng))
                for _ in range(self.matrix.num_initial_runs)
            ]
        u = self._maximize_acquisition()
        return [Suggestion(params=self._decode(u))]

    def observe(self, results):
        prev_best = max(self._y) if self._y else None
        had_result = False
        for sug, obj in results:
            if obj is None:
                continue
            had_result = True
            self._X.append(self._encode(sug.params))
            self._y.append(float(obj))
        self._iteration += 1
        self._after_observe(prev_best, had_result)

    def _after_observe(self, prev_best, had_result):
        """Hook for trust-region subclasses; base GP search has no state."""

    # GP machinery ----------------------------------------------------
    def _gp_posterior(self, Xs: np.ndarray):
        return gp_posterior(np.asarray(self._X), np.asarray(self._y), Xs, ls=0.2)

    def _maximize_acquisition(self) -> np.ndarray:
        m = 512
        cand = self._rng.random((m, len(self._names)))
        if not self._X:
            return cand[0]
        mu, sd = self._gp_posterior(cand)
        best = max(self._y)
        if self._acq == "ucb":
            score = mu + self._kappa * sd
        elif self._acq == "ei":
            z = (mu - best - self._eps) / sd
            score = (mu - best - self._eps) * _ncdf(z) + sd * _npdf(z)
        elif self._acq == "pi":
            score = _ncdf((mu - best - self._eps) / sd)
        else:
            raise ValueError(f"unknown acquisition {self._acq!r}")
        return cand[int(np.argmax(score))]


def gp_posterior(X: np.ndarray, y: np.ndarray, Xs: np.ndarray, ls: float):
    """Shared RBF-kernel GP posterior (unit-variance prior, Cholesky solve):
    → (mu, sd) at candidate points Xs. One copy for every BO manager."""
    mu0 = y.mean() if len(y) else 0.0
    sig0 = y.std() + 1e-9 if len(y) else 1.0
    yn = (y - mu0) / sig0
    noise = 1e-6

    def k(a, b):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / ls**2)

    K = k(X, X) + noise * np.eye(len(X))
    L = np.linalg.cholesky(K)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
    Ks = k(X, Xs)  # [n, m]
    mu = Ks.T @ alpha
    v = np.linalg.solve(L, Ks)
    var = np.clip(1.0 - (v**2).sum(0), 1e-12, None)
    return mu * sig0 + mu0, np.sqrt(var) * sig0


def _ncdf(z):
    return 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))


def _npdf(z):
    return np.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)


class HyperoptManager(SearchManager):
    """TPE ('tpe'), annealing ('anneal'), or random ('rand') — numpy-only
    stand-ins for the hyperopt algorithms the reference shells out to."""

    def __init__(self, matrix: V1Hyperopt):
        self.matrix = matrix
        self._rng = np.random.default_rng(matrix.seed or 0)
        self._names = sorted(matrix.params)
        self._X: list[list[float]] = []
        self._y: list[float] = []
        self._count = 0
        self._warmup = max(4, matrix.num_runs // 4)

    @property
    def done(self) -> bool:
        return self._count >= self.matrix.num_runs

    def suggest(self) -> list[Suggestion]:
        algo = self.matrix.algorithm
        if algo == "rand" or self._count < self._warmup or not self._X:
            cfg = sample_config(self.matrix.params, self._rng)
            return [Suggestion(params=cfg)]
        if algo == "anneal":
            u = self._anneal_point()
        else:
            u = self._tpe_point()
        cfg = {
            n: from_unit(self.matrix.params[n], float(u[i]))
            for i, n in enumerate(self._names)
        }
        return [Suggestion(params=cfg)]

    def observe(self, results):
        for sug, obj in results:
            self._count += 1
            if obj is None:
                continue
            self._X.append(
                [to_unit(self.matrix.params[n], sug.params[n]) for n in self._names]
            )
            self._y.append(float(obj))

    def _anneal_point(self) -> np.ndarray:
        # sample near the best point with shrinking radius
        best = np.asarray(self._X[int(np.argmax(self._y))])
        radius = max(0.05, 1.0 / (1 + len(self._y) * 0.3))
        return np.clip(best + self._rng.normal(0, radius, best.shape), 0, 1)

    def _tpe_point(self) -> np.ndarray:
        X = np.asarray(self._X)
        y = np.asarray(self._y)
        gamma = 0.25
        n_good = max(1, int(math.ceil(gamma * len(y))))
        order = np.argsort(-y)  # descending (higher better)
        good, bad = X[order[:n_good]], X[order[n_good:]]
        if len(bad) == 0:
            bad = X
        bw = 0.15
        cand = np.clip(
            good[self._rng.integers(len(good), size=64)]
            + self._rng.normal(0, bw, (64, X.shape[1])),
            0,
            1,
        )

        def kde(points, xs):
            d2 = ((xs[:, None, :] - points[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / bw**2).mean(1) + 1e-12

        score = kde(good, cand) / kde(bad, cand)
        return cand[int(np.argmax(score))]


class IterativeManager(SearchManager):
    """max_iterations rounds of one random suggestion each — the open-loop
    iterative tuner (the reference delegates per-round logic to a user
    container; locally each round just resamples)."""

    def __init__(self, matrix: V1Iterative):
        self.matrix = matrix
        self._rng = np.random.default_rng(matrix.seed or 0)
        self._iteration = 0

    @property
    def done(self) -> bool:
        return self._iteration >= self.matrix.max_iterations

    def suggest(self) -> list[Suggestion]:
        return [Suggestion(params=sample_config(self.matrix.params, self._rng))]

    def observe(self, results):
        self._iteration += 1


class _TrustRegion:
    """TuRBO-style trust-region state (Eriksson et al. 2019): a box around
    the incumbent whose side length doubles after `succ_tol` consecutive
    improvements and halves after `fail_tol` consecutive misses; collapse
    below `length_min` signals a restart (or, in BAxUS, a subspace split)."""

    def __init__(self, dim: int, cfg: Optional[dict] = None):
        cfg = {**(cfg or {})}
        get = lambda *keys, default: next(  # noqa: E731
            (float(cfg[k]) for k in keys if k in cfg), default
        )
        self.length_init = get("lengthInit", "length_init", default=0.8)
        self.length_min = get("lengthMin", "length_min", default=0.5**7)
        self.length_max = get("lengthMax", "length_max", default=1.6)
        self.succ_tol = int(get("succTol", "succ_tol", default=3))
        self.fail_tol = int(get("failTol", "fail_tol", default=max(4.0, float(dim))))
        self.length = self.length_init
        self._succ = self._fail = 0

    def update(self, improved: bool):
        if improved:
            self._succ, self._fail = self._succ + 1, 0
            if self._succ >= self.succ_tol:
                self.length = min(2.0 * self.length, self.length_max)
                self._succ = 0
        else:
            self._succ, self._fail = 0, self._fail + 1
            if self._fail >= self.fail_tol:
                self.length /= 2.0
                self._fail = 0

    @property
    def collapsed(self) -> bool:
        return self.length < self.length_min

    def reset(self):
        self.length = self.length_init
        self._succ = self._fail = 0


class _TrustRegionSearch:
    """Shared trust-region bookkeeping for TuRBO/BAxUS: rounds with no
    completed trial (all objectives None — infrastructure failures) do NOT
    count as evaluated misses, so crashes alone never shrink the region."""

    _tr: _TrustRegion
    _y: list[float]

    def _update_trust_region(self, prev_best, had_result):
        if not had_result or prev_best is None:
            return
        best = max(self._y)
        improved = best > prev_best + 1e-3 * abs(prev_best)
        self._tr.update(improved)
        if self._tr.collapsed:
            self._on_collapse()

    def _on_collapse(self):
        self._tr.reset()


class TurboBayesManager(_TrustRegionSearch, BayesSearchManager):
    """Trust-region BO (TuRBO-1): the GP's Thompson sample is maximized only
    inside a box around the incumbent, so the search exploits locally
    instead of over-exploring the corners the way a global acquisition does
    in higher dimensions. On collapse the region restarts at full size
    around the running incumbent (observations are kept — the local GP has
    more data than a cold restart and the box keeps it local)."""

    def __init__(self, matrix: V1Bayes):
        super().__init__(matrix)
        self._tr = _TrustRegion(len(self._names), matrix.trust_region)

    def _after_observe(self, prev_best, had_result):
        self._update_trust_region(prev_best, had_result)

    def _maximize_acquisition(self) -> np.ndarray:
        if not self._X:
            return self._rng.random(len(self._names))
        center = np.asarray(self._X[int(np.argmax(self._y))])
        half = self._tr.length / 2.0
        lb = np.clip(center - half, 0.0, 1.0)
        ub = np.clip(center + half, 0.0, 1.0)
        cand = lb + (ub - lb) * self._rng.random((512, len(self._names)))
        mu, sd = self._gp_posterior(cand)
        # Thompson sample: one posterior draw per candidate (TuRBO's choice —
        # naturally balances explore/exploit inside the region)
        draw = mu + sd * self._rng.standard_normal(len(cand))
        return cand[int(np.argmax(draw))]


class BaxusBayesManager(_TrustRegionSearch, SearchManager):
    """Expanding-subspace BO (BAxUS, Papenmeier et al. 2022 — the fork
    author's research line; SURVEY.md:36-38 flags Polytune as the likely
    fork divergence): BO runs in a low-dimensional target space embedded
    into the full parameter space by a sparse axis-aligned ±1 assignment
    (every input dim belongs to exactly one target bin). When the trust
    region collapses, each bin SPLITS, doubling the target dimension while
    re-expressing every past observation EXACTLY in the finer space — no
    information is discarded on the way from d0 up to the full D."""

    def __init__(self, matrix: V1Bayes):
        self.matrix = matrix
        self._rng = np.random.default_rng(matrix.seed or 0)
        self._names = sorted(matrix.params)
        D = len(self._names)
        d0 = int(matrix.initial_target_dim or min(2, D))
        self._d = max(1, min(d0, D))
        # input dim i → (bin, sign): bins as equal contiguous groups
        bins = np.array_split(np.arange(D), self._d)
        self._bin = np.empty(D, dtype=int)
        for b, idxs in enumerate(bins):
            self._bin[idxs] = b
        self._sign = self._rng.choice([-1.0, 1.0], size=D)
        self._Z: list[np.ndarray] = []  # target-space points in [-1, 1]^d
        self._y: list[float] = []
        self._iteration = 0
        self._tr = _TrustRegion(self._d, matrix.trust_region)

    @property
    def done(self) -> bool:
        return self._iteration >= self.matrix.max_iterations + 1

    @property
    def target_dim(self) -> int:
        return self._d

    # ---------------------------------------------------------- embedding
    def _embed(self, z: np.ndarray) -> np.ndarray:
        """[-1,1]^d target point → unit-cube input point."""
        x = 0.5 + 0.5 * self._sign * z[self._bin]
        return np.clip(x, 0.0, 1.0)

    def _decode(self, z: np.ndarray) -> dict:
        x = self._embed(z)
        return {
            n: from_unit(self.matrix.params[n], float(x[i]))
            for i, n in enumerate(self._names)
        }

    def _split_bins(self):
        """Double the target dimension: each bin's input dims are split
        into two child bins; a past z re-expressed with both children equal
        to the parent coordinate embeds to the IDENTICAL input point."""
        D = len(self._names)
        new_bin = np.empty(D, dtype=int)
        child_of: list[int] = []  # new bin index → parent bin
        next_id = 0
        for b in range(self._d):
            idxs = np.where(self._bin == b)[0]
            halves = [h for h in np.array_split(idxs, 2) if len(h)]
            for h in halves:
                new_bin[h] = next_id
                child_of.append(b)
                next_id += 1
        self._Z = [z[np.asarray(child_of)] for z in self._Z]
        self._bin = new_bin
        self._d = next_id
        self._tr = _TrustRegion(self._d, self.matrix.trust_region)

    # ------------------------------------------------------------- search
    def suggest(self) -> list[Suggestion]:
        if self._iteration == 0:
            return [
                Suggestion(
                    params=self._decode(self._rng.uniform(-1, 1, self._d))
                )
                for _ in range(self.matrix.num_initial_runs)
            ]
        z = self._next_point()
        return [Suggestion(params=self._decode(z))]

    def _next_point(self) -> np.ndarray:
        if not self._Z:
            return self._rng.uniform(-1, 1, self._d)
        Z = np.stack(self._Z)
        center = Z[int(np.argmax(self._y))]
        half = self._tr.length  # z-space spans [-1,1]: length is the half-width
        lb = np.clip(center - half, -1.0, 1.0)
        ub = np.clip(center + half, -1.0, 1.0)
        cand = lb + (ub - lb) * self._rng.random((512, self._d))
        # z-space spans [-1,1]: wider lengthscale than the unit-cube GP
        mu, sd = gp_posterior(Z, np.asarray(self._y), cand, ls=0.4)
        draw = mu + sd * self._rng.standard_normal(len(cand))
        return cand[int(np.argmax(draw))]

    def observe(self, results):
        prev_best = max(self._y) if self._y else None
        had_result = False
        for sug, obj in results:
            if obj is None:
                continue
            had_result = True
            self._Z.append(self._z_for(sug))
            self._y.append(float(obj))
        self._iteration += 1
        self._update_trust_region(prev_best, had_result)

    def _on_collapse(self):
        if self._d < len(self._names):
            self._split_bins()
        else:
            self._tr.reset()

    def _z_for(self, sug: Suggestion) -> np.ndarray:
        """Recover the target point for a suggestion: invert the embedding
        bin-by-bin (each bin's coordinate is over-determined by its input
        dims; use the mean of the consistent estimates)."""
        x = np.array(
            [to_unit(self.matrix.params[n], sug.params[n]) for n in self._names]
        )
        zhat = self._sign * (2.0 * x - 1.0)
        z = np.zeros(self._d)
        for b in range(self._d):
            z[b] = zhat[self._bin == b].mean()
        return np.clip(z, -1.0, 1.0)


def _build_bayes(matrix: V1Bayes) -> SearchManager:
    return {
        "gp": BayesSearchManager,
        "turbo": TurboBayesManager,
        "baxus": BaxusBayesManager,
    }[matrix.algorithm](matrix)


def build_manager(matrix: V1Matrix) -> SearchManager:
    managers = {
        "grid": GridSearchManager,
        "random": RandomSearchManager,
        "mapping": MappingManager,
        "hyperband": HyperbandManager,
        "asha": AshaManager,
        "bayes": _build_bayes,
        "hyperopt": HyperoptManager,
        "iterative": IterativeManager,
    }
    if matrix.kind not in managers:
        raise ValueError(f"no search manager for matrix kind {matrix.kind!r}")
    return managers[matrix.kind](matrix)
