"""Scaling Information Base (SIB) + analytical iteration-time model (§5.5).

T_p(R) = α_p + β_p · Σ len + γ_p · Σ len²   (Eq. 7)

Coefficients are least-squares fitted per parallelism strategy (keyed by DoP)
from profiling samples. Before any profiles exist the SIB bootstraps from a
hardware napkin model (params FLOPs / chip peak), so the scheduler always has
an estimate; profiled data then overrides it — mirroring the paper's SQLite
profile store + offline fit.

A linear model covers the decode phase (α + β·batch + γ·Σ kv_len), which the
paper treats with the same machinery.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class PrefillCoeffs:
    alpha: float
    beta: float
    gamma: float

    def predict(self, sum_len: float, sum_len2: float) -> float:
        return self.alpha + self.beta * sum_len + self.gamma * sum_len2


@dataclass
class DecodeCoeffs:
    alpha: float
    beta: float  # per request in batch
    gamma: float  # per cached token

    def predict(self, batch: float, sum_kv: float) -> float:
        return self.alpha + self.beta * batch + self.gamma * sum_kv


@dataclass
class HardwareSpec:
    """NVIDIA H100 SXM defaults (per card), from NVIDIA's H100 data sheet:
    989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB HBM3, NVLink 900 GB/s
    total = 450 GB/s each way.  One card per elastic instance.

    ``net_bw`` is the card's link out of its node: an HGX H100 node pairs
    each of its 8 cards with one NDR InfiniBand adapter, 400 Gb/s = 50 GB/s
    each way (NVIDIA DGX H100 data sheet: eight ConnectX-7 400 Gb/s ports
    for compute traffic).  A collective group that spans nodes, as every
    "data" or "model" group of the (16, 16) production meshes does, runs at
    that rate; NVLink's ``ici_bw`` holds only inside one node."""

    peak_flops: float = 989e12  # bf16, dense
    hbm_bw: float = 3.35e12
    ici_bw: float = 450e9  # NVLink, each way
    hbm_bytes: float = 80e9
    net_bw: float = 50e9  # NDR InfiniBand, per card, each way
    chips_per_instance: int = 1
    mfu: float = 0.45  # sustained fraction for the napkin bootstrap
    decode_hbm_eff: float = 0.6


class SIB:
    def __init__(self, cfg: ModelConfig, hw: Optional[HardwareSpec] = None):
        self.cfg = cfg
        self.hw = hw or HardwareSpec()
        # dop -> samples
        self._prefill_samples: Dict[int, List[Tuple[float, float, float]]] = {}
        self._decode_samples: Dict[int, List[Tuple[float, float, float]]] = {}
        self._prefill_fit: Dict[int, PrefillCoeffs] = {}
        self._decode_fit: Dict[int, DecodeCoeffs] = {}
        # per-instance relative speed (1.0 = nominal); stragglers < 1.0
        self.instance_speed: Dict[int, float] = {}
        self._n2 = 2 * self.cfg.param_count(active_only=True)

    # ---------------------------------------------------------------- record
    def record_prefill(self, dop: int, lens: Sequence[int], t: float) -> None:
        s1 = float(sum(lens))
        s2 = float(sum(l * l for l in lens))
        self._prefill_samples.setdefault(dop, []).append((s1, s2, t))
        self._prefill_fit.pop(dop, None)

    def record_decode(self, dop: int, batch: int, sum_kv: int, t: float) -> None:
        self._decode_samples.setdefault(dop, []).append(
            (float(batch), float(sum_kv), t)
        )
        self._decode_fit.pop(dop, None)

    def set_instance_speed(self, instance: int, speed: float) -> None:
        self.instance_speed[instance] = speed

    def group_speed(self, instances: Sequence[int]) -> float:
        """A group is bottlenecked by its slowest member (§2.4)."""
        if not instances:
            return 1.0
        return min(self.instance_speed.get(i, 1.0) for i in instances)

    # ------------------------------------------------------------------- fit
    def _fit_prefill(self, dop: int) -> PrefillCoeffs:
        if dop in self._prefill_fit:
            return self._prefill_fit[dop]
        samples = self._prefill_samples.get(dop, [])
        if len(samples) >= 4:
            a = np.array([[1.0, s1, s2] for s1, s2, _ in samples])
            y = np.array([t for _, _, t in samples])
            coef, *_ = np.linalg.lstsq(a, y, rcond=None)
            fit = PrefillCoeffs(*[float(c) for c in coef])
            # degenerate fits (tiny profile sets) fall back to the napkin
            if fit.beta <= 0 or fit.gamma < 0:
                fit = self._napkin_prefill(dop)
        else:
            fit = self._napkin_prefill(dop)
        self._prefill_fit[dop] = fit
        return fit

    def _napkin_prefill(self, dop: int) -> PrefillCoeffs:
        hw, cfg = self.hw, self.cfg
        rate = dop * hw.chips_per_instance * hw.peak_flops * hw.mfu
        # β: linear FLOPs = 2·N_active per token; γ: attention 2·2·L·H·Dh per
        # token-pair (QK^T + PV), halved for causality.
        beta = self._n2 / rate
        attn_pair = 2 * cfg.n_attention_applications * cfg.n_heads * cfg.head_dim * 2
        gamma = 0.5 * attn_pair / rate
        alpha = 0.003  # dispatch/launch overhead floor (s)
        return PrefillCoeffs(alpha, beta, gamma)

    def _fit_decode(self, dop: int) -> DecodeCoeffs:
        if dop in self._decode_fit:
            return self._decode_fit[dop]
        samples = self._decode_samples.get(dop, [])
        if len(samples) >= 4:
            a = np.array([[1.0, b, kv] for b, kv, _ in samples])
            y = np.array([t for _, _, t in samples])
            coef, *_ = np.linalg.lstsq(a, y, rcond=None)
            fit = DecodeCoeffs(*[float(c) for c in coef])
            if fit.beta < 0 or fit.gamma < 0:
                fit = self._napkin_decode(dop)
        else:
            fit = self._napkin_decode(dop)
        self._decode_fit[dop] = fit
        return fit

    def _napkin_decode(self, dop: int) -> DecodeCoeffs:
        hw, cfg = self.hw, self.cfg
        chips = dop * hw.chips_per_instance
        # decode is HBM-bound: weights once per step + KV stream
        weight_bytes = 2 * self.cfg.param_count(active_only=True)
        alpha = 0.002 + weight_bytes / (chips * hw.hbm_bw * hw.decode_hbm_eff)
        beta = self._n2 / (chips * hw.peak_flops * hw.mfu)
        kv_per_tok = max(cfg.kv_bytes_per_token, 1)
        gamma = kv_per_tok / (chips * hw.hbm_bw * hw.decode_hbm_eff)
        # communication penalty for distributing decode (q broadcast +
        # partial combine), per §2.4's poor decode scaling
        comm = 2e-5 * math.log2(max(dop, 1) + 1)
        return DecodeCoeffs(alpha + comm, beta, gamma)

    # ------------------------------------------------------------- estimates
    def prefill_time(self, dop: int, lens: Sequence[int],
                     instances: Optional[Sequence[int]] = None) -> float:
        fit = self._fit_prefill(dop)
        s1 = float(sum(lens))
        s2 = float(sum(l * l for l in lens))
        t = fit.predict(s1, s2)
        return t / self.group_speed(instances or [])

    def decode_time(self, dop: int, batch: int, sum_kv: int,
                    instances: Optional[Sequence[int]] = None) -> float:
        fit = self._fit_decode(dop)
        t = fit.predict(batch, sum_kv)
        return t / self.group_speed(instances or [])

    def migration_time(self, n_tokens: int, n_links: int = 1) -> float:
        bytes_ = n_tokens * max(self.cfg.kv_bytes_per_token, 1)
        return bytes_ / (self.hw.ici_bw * max(n_links, 1))

    # ------------------------------------------------------ scheduler knobs
    def prefill_tipping_point(self, dop: int) -> float:
        """Upper bound of the memory-bound regime (§5.1): iteration time at
        which a prefill batch saturates compute. Profilable; napkin default
        = time to read weights at HBM speed x compute/memory crossover."""
        hw = self.hw
        chips = dop * hw.chips_per_instance
        weight_bytes = 2 * self.cfg.param_count(active_only=True)
        t_mem = weight_bytes / (chips * hw.hbm_bw)
        # a batch is memory-bound while compute time < weight-read time;
        # sustained-efficiency margin on top.
        return t_mem / hw.mfu

    def decode_compute_bound_batch(self, dop: int) -> int:
        """Batch-size threshold past which decode FFN turns compute-bound
        (§5.4). Ridge point: B* ~ peak_flops/hbm_bw (ops per weight byte)."""
        ridge = self.hw.peak_flops / self.hw.hbm_bw  # ~240 for v5e
        return int(ridge)

    def min_best_decode_dop(self) -> int:
        """§5.4: the minimum best DoP for the decoding phase, used as the
        model-parallel degree at launch. For HBM-bound decode more instances
        only help once KV streaming dominates; 1 is the right floor."""
        return 1
