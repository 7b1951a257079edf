"""Build-time configuration for an IVFADC index (PyTorch port of
`ivfadc_tpu/config.py`: same fields, defaults and validation).

Defaults mirror the reference library's constants (reference:
IVFADC.jl src/defaults.jl:2-10) and the constructor keyword arguments
(IVFADC.jl src/index.jl:103-114), re-expressed as a frozen dataclass.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

# Code / id dtypes supported, and the bit widths used by the capacity law
# (reference: QuantizedArrays.TYPE_TO_BITS used at IVFADC.jl src/index.jl:124
#  and IVFADC.jl src/utils.jl:134).
DTYPE_TO_BITS = {
    "uint8": 8,
    "uint16": 16,
    "uint32": 32,
    "uint64": 64,
}

# Device-side id representation cap: the search kernels stream and emit
# ids as int32 (ids2d rows, fold payloads; negatives mark padding), so an
# index's external ids must stay below 2^31 however wide `index_dtype` is
# on the host. Ids above the cap would wrap negative on the device and
# silently vanish from results.
DEVICE_ID_CAP = 1 << 31


def device_id_cap() -> int:
    """The active device int32 id cap. Overridable via IVFADC_DEVICE_ID_CAP
    so the beyond-cap machinery is testable at toy scale. The override can
    only LOWER the cap: a value above 2^31 is clamped, since device ids are
    int32 and a larger cap would let them wrap negative unnoticed."""
    v = os.environ.get("IVFADC_DEVICE_ID_CAP")
    return min(int(v), DEVICE_ID_CAP) if v else DEVICE_ID_CAP


VALID_QUANTIZATION_METHODS = ("pq", "opq")
# "naive" = brute-force matmul coarse scan; "hnsw" is accepted for API parity
# with the reference (IVFADC.jl src/defaults.jl:7) and maps to the
# two-level coarse quantizer ("two_level" is its native name).
VALID_COARSE_QUANTIZERS = ("naive", "hnsw", "two_level")


def code_dtype_for_k(k: int) -> str:
    """Smallest unsigned dtype that can hold codes in [0, k)."""
    if k <= 256:
        return "uint8"
    if k <= 65536:
        return "uint16"
    return "uint32"


def bits_required(n: int) -> int:
    """ceil(log2(n)) — the id-width capacity law of the reference
    (IVFADC.jl src/index.jl:117)."""
    if n <= 1:
        return 0
    return int(math.ceil(math.log2(n)))


@dataclasses.dataclass(frozen=True)
class IVFADCConfig:
    """Hyperparameters for building an IVFADC index.

    Field-by-field parity with the reference constructor kwargs
    (IVFADC.jl src/index.jl:103-114):
      kc                   <- kc            (DEFAULT_COARSE_K = 2)
      k                    <- k             (DEFAULT_QUANTIZATION_K = 256)
      m                    <- m             (DEFAULT_QUANTIZATION_M = 1)
      coarse_quantizer     <- coarse_quantizer (:naive)
      coarse_metric        <- coarse_distance  (SqEuclidean)
      quantization_metric  <- quantization_distance (SqEuclidean)
      quantization_method  <- quantization_method (:pq)
      coarse_maxiter       <- coarse_maxiter (25)
      quantization_maxiter <- quantization_maxiter (25)
      index_dtype          <- index_type    (UInt32)
    Engine additions: seed, opq_iters, block sizes, slack factor.
    """

    kc: int = 2
    k: int = 256
    m: int = 1
    coarse_quantizer: str = "naive"
    coarse_metric: str = "sqeuclidean"
    quantization_metric: str = "sqeuclidean"
    quantization_method: str = "pq"
    coarse_maxiter: int = 25
    quantization_maxiter: int = 25
    index_dtype: str = "uint32"

    # Engine-specific knobs (no reference counterpart).
    seed: int = 0
    coarse_n_groups: int = 0        # two-level coarse: number of centroid
                                    # groups (0 = ceil(sqrt(kc)))
    coarse_probe_groups: int = 0    # groups probed per query (0 = auto: g/4
                                    # at small g tapering to g/16, min 8);
                                    # the two-level recall/speed dial
    opq_iters: int = 4              # outer alternations for OPQ rotation learning
    kmeans_block: int = 16384       # points per chunk in the assignment step
    cell_slack: float = 1.25        # padded-CSR over-allocation factor per cell
    kmeanspp_sample: int = 0        # 0 = seed k-means++ on all points; else subsample cap
    quantization_sample: int = 0    # 0 = train PQ codebooks on all residuals
                                    # (auto-capped at 2^20 for larger builds);
                                    # else train on a uniform subsample of
                                    # this many (encode always runs on
                                    # everything)
    score_mode: str = "reference"   # "reference": coarse_dist + sum(ADC table)
                                    #   (parity with IVFADC.jl src/index.jl:242-246)
                                    # "pure": sum(ADC table) only (classic IVFADC estimator)
    scan_mode: str = "auto"         # "dense": hand-written scan kernel over
                                    #   resident decoded residuals;
                                    # "lut": table-lookup scan (memory-lean,
                                    #   any additive metric);
                                    # "auto": dense on a CUDA device when the
                                    #   metric supports it, lut otherwise
    scan_chunk: int = 1024          # rows per scan chunk; fold results do not
                                    # depend on it (scan_fold_lanes divides it)
    scan_pb: int = 64               # probes per kernel tile (query grouping)
    scan_fold_lanes: int = 128      # fold-merge candidate-buffer width per
                                    # probe (128-multiple dividing scan_chunk);
                                    # wider cuts fold collisions but writes
                                    # more candidates to device memory
    scan_cache: str = "auto"        # decoded-residual cache dtype for the
                                    # dense scan: "bf16" (2 B/dim) or "int8"
                                    # (1 B/dim + per-column scale, half the
                                    # bytes the scan reads; quantization error
                                    # of the order of bf16 rounding); "auto":
                                    # int8
    cell_align: int = 0             # cell capacity alignment in rows: 0 auto
                                    # (128 when kc <= 16384, which lets the
                                    # grouped scan emit external ids; else 8)
    scan_gather_win: int = 0        # tiny-cell engine threshold (rows) for
                                    # huge-kc indexes; 0 (default) disables
    scan_merge: str = "auto"        # in-kernel candidate upkeep:
                                    # "exact": k min-extract passes per chunk
                                    #   (true per-probe top-k);
                                    # "fold": per-lane running min, exact for
                                    #   cells <= scan_fold_lanes postings;
                                    # "auto": fold

    def __post_init__(self):
        if self.quantization_method not in VALID_QUANTIZATION_METHODS:
            raise ValueError(
                f"quantization_method must be one of {VALID_QUANTIZATION_METHODS}, "
                f"got {self.quantization_method!r}")
        if self.coarse_quantizer not in VALID_COARSE_QUANTIZERS:
            raise ValueError(
                f"coarse_quantizer must be one of {VALID_COARSE_QUANTIZERS}, "
                f"got {self.coarse_quantizer!r}")
        if self.index_dtype not in DTYPE_TO_BITS:
            raise ValueError(f"index_dtype must be one of {tuple(DTYPE_TO_BITS)}, "
                             f"got {self.index_dtype!r}")
        if self.score_mode not in ("reference", "pure"):
            raise ValueError(f"score_mode must be 'reference' or 'pure', got {self.score_mode!r}")
        if self.scan_mode not in ("auto", "dense", "lut"):
            raise ValueError(f"scan_mode must be 'auto', 'dense' or 'lut', got {self.scan_mode!r}")
        if self.scan_cache not in ("auto", "bf16", "int8"):
            raise ValueError(f"scan_cache must be 'auto', 'bf16' or 'int8', "
                             f"got {self.scan_cache!r}")
        if self.scan_merge not in ("auto", "exact", "fold"):
            raise ValueError(f"scan_merge must be 'auto', 'exact' or 'fold', "
                             f"got {self.scan_merge!r}")
        if (self.scan_fold_lanes % 128 != 0
                or self.scan_chunk % self.scan_fold_lanes != 0):
            raise ValueError(
                f"scan_fold_lanes must be a 128-multiple dividing scan_chunk, "
                f"got {self.scan_fold_lanes} (chunk {self.scan_chunk})")
        if self.scan_gather_win < 0:
            raise ValueError(
                f"scan_gather_win must be >= 0, got {self.scan_gather_win}")
        if self.cell_align not in (0, 8, 128):
            raise ValueError(
                f"cell_align must be 0 (auto), 8 or 128, got {self.cell_align}")

    def validate_for_data(self, n: int, d: int) -> None:
        """Build-time assertions, 1:1 with IVFADC.jl src/index.jl:116-125,
        plus the device int32 id cap."""
        if self.kc < 2:
            raise AssertionError("Number of coarse clusters has to be >= 2")
        if self.k > n:
            raise AssertionError(f"Number of quantization levels has to be <= {n}")
        if not (1 <= self.m <= d):
            raise AssertionError(f"Number of codebooks has to be between 1 and {d}")
        # m need not divide d (the reference allows ragged subspace splits
        # via rowrange); the quantizer zero-pads to m * ceil(d/m) internally.
        if self.coarse_maxiter <= 0 or self.quantization_maxiter <= 0:
            raise AssertionError("Number of clustering iterations has to be > 0")
        if DTYPE_TO_BITS[self.index_dtype] < bits_required(n):
            raise AssertionError(
                f"{n} vectors require at least {bits_required(n)} index bits")
        if n > device_id_cap():
            raise AssertionError(
                f"{n} vectors exceed the device int32 id representation "
                f"({device_id_cap()}); sharded views, whose wide-id mode "
                f"lifts the cap, are not ported yet (ROADMAP A.14)")

    @property
    def code_dtype(self) -> str:
        return code_dtype_for_k(self.k)

    @property
    def id_np_dtype(self) -> np.dtype:
        return np.dtype(self.index_dtype)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "IVFADCConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{key: val for key, val in d.items() if key in known})
