"""Accept-rate-driven control of the speculative draft width K, counterpart
of `polyaxon_tpu/serving/adaptive.py` (an own copy: the port imports
nothing of the JAX package).

A K-draft verify window costs one (K+1)-wide forward and pays off only
when drafts are accepted. `AdaptiveSpecController` watches the accept
counts of the verify windows and steers K, AIMD-shaped:

* every `observe(proposed, accepted)` feeds one window's counts into the
  current evaluation window; once `window` proposals accumulate, the
  corrected accept rate decides: >= `raise_at` → K += 1 (cap `k_max`),
  < `lower_at` → K halves (floor `k_min`), < `disable_at` while at `k_min`
  → speculation turns OFF;
* disabled means plain decode (`window_k() == 0`); each plain step reports
  `tick_plain(n)`, and after `reprobe` logical steps the controller
  re-enables at `k_min` for one fresh evaluation window;
* the CORRECTED accept rate (commit_window's `accepted_judged`) decides:
  the committed rate deflates near maxNewTokens, where a budget clamp cuts
  an accepted run.

Everything counts logical units (proposed tokens, decode steps), never
wall clocks, so K decisions replay. One lock covers the integers: serving
reads `window_k()` on producer threads and feeds back on the worker.
"""

from __future__ import annotations

import threading


class AdaptiveSpecController:
    """AIMD controller for the speculative draft width K.

    `window_k()` is the current decision: 0 = speculation disabled (run
    plain decode), k >= 1 = propose k drafts per verify window. Callers
    feed back `observe(proposed, accepted)` per verify window and
    `tick_plain(steps)` per plain decode step while disabled.
    """

    def __init__(
        self,
        *,
        k_init: int = 4,
        k_min: int = 1,
        k_max: int = 8,
        window: int = 64,
        raise_at: float = 0.6,
        lower_at: float = 0.2,
        disable_at: float = 0.1,
        reprobe: int = 256,
    ):
        if not (1 <= k_min <= k_init <= k_max):
            raise ValueError(
                f"need 1 <= k_min <= k_init <= k_max, got "
                f"{k_min}/{k_init}/{k_max}"
            )
        if not (0.0 <= disable_at <= lower_at <= raise_at <= 1.0):
            raise ValueError(
                f"need 0 <= disable_at <= lower_at <= raise_at <= 1, got "
                f"{disable_at}/{lower_at}/{raise_at}"
            )
        self.k_min = int(k_min)
        self.k_max = int(k_max)
        self.window = max(1, int(window))
        self.raise_at = float(raise_at)
        self.lower_at = float(lower_at)
        self.disable_at = float(disable_at)
        self.reprobe = max(1, int(reprobe))
        self._lock = threading.Lock()
        self._k = int(k_init)
        self._disabled = False
        # current evaluation window
        self._proposed = 0
        self._accepted = 0
        # lifetime accounting (corrected, i.e. accepted_judged)
        self.total_proposed = 0
        self.total_accepted = 0
        # raw committed counts ride along for the /statsz raw rate
        self.total_accepted_raw = 0
        self._plain_ticks = 0
        self.adjustments = 0  # K changes (either direction)
        self.disables = 0
        self.reprobes = 0

    # ------------------------------------------------------------- decisions
    def window_k(self) -> int:
        """Draft width for the next verify window; 0 = run plain decode."""
        with self._lock:
            return 0 if self._disabled else self._k

    @property
    def effective_k(self) -> int:
        return self.window_k()

    @property
    def auto_disabled(self) -> bool:
        with self._lock:
            return self._disabled

    # -------------------------------------------------------------- feedback
    def observe(self, proposed: int, accepted: int,
                accepted_raw: int | None = None) -> None:
        """Feed one verify window's counts: `proposed` drafts offered,
        `accepted` the truncation-CORRECTED accepts (accepted_judged).
        `accepted_raw` (committed accepts) only feeds the /statsz raw
        rate and defaults to `accepted`."""
        with self._lock:
            self.total_proposed += int(proposed)
            self.total_accepted += int(accepted)
            self.total_accepted_raw += int(
                accepted if accepted_raw is None else accepted_raw
            )
            if self._disabled:
                return  # stale feedback from in-flight spec groups
            self._proposed += int(proposed)
            self._accepted += int(accepted)
            if self._proposed < self.window:
                return
            rate = self._accepted / self._proposed
            self._proposed = 0
            self._accepted = 0
            if rate >= self.raise_at and self._k < self.k_max:
                self._k += 1
                self.adjustments += 1
            elif rate < self.disable_at and self._k <= self.k_min:
                self._disabled = True
                self._plain_ticks = 0
                self.disables += 1
            elif rate < self.lower_at and self._k > self.k_min:
                self._k = max(self.k_min, self._k // 2)
                self.adjustments += 1

    def tick_plain(self, steps: int = 1) -> None:
        """Count logical plain decode steps while disabled; after
        `reprobe` of them speculation re-enables at k_min for one fresh
        evaluation window."""
        with self._lock:
            if not self._disabled:
                return
            self._plain_ticks += int(steps)
            if self._plain_ticks >= self.reprobe:
                self._disabled = False
                self._k = self.k_min
                self._proposed = 0
                self._accepted = 0
                self._plain_ticks = 0
                self.reprobes += 1

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            prop = self.total_proposed
            return {
                "effective_k": 0 if self._disabled else self._k,
                "auto_disabled": self._disabled,
                "accept_rate_raw": (
                    self.total_accepted_raw / prop if prop else 0.0
                ),
                "accept_rate_corrected": (
                    self.total_accepted / prop if prop else 0.0
                ),
                "adjustments": self.adjustments,
                "disables": self.disables,
                "reprobes": self.reprobes,
            }
