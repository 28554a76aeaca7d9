"""Run configuration: the twin of ``bella_tpu.config.BellaConfig``.

Every field keeps its name and default so a configuration carries across
(``config_from_reference``), including ``pallas_band``, which here sizes
the static band of the CUDA kernel, and ``profile_dir``, where
``--profile`` writes a ``torch.profiler`` trace. The JAX package's
``prewarm`` has no counterpart: the port compiles nothing ahead.

``aligner_backend`` picks the alignment path by bella_tpu's rule with one
difference. "pallas" and "auto" take the static-band path (kernel K1, the
2x-band rescue cascade, the adaptive exactness tail): bella_tpu's "auto"
means its accelerator kernel where there is one, and for the port the card
is that accelerator. Any other value ("jax") takes the adaptive-band path:
kernel K2 at ``band_width`` on every pair, with no cascade, no tail and no
K1-against-K2 check.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# fields of bella_tpu.BellaConfig that the port drops on purpose
DROPPED_FIELDS = ("prewarm",)


@dataclasses.dataclass
class BellaConfig:
    # --- reference BELLApars (include/common/common.h:46-74) ---
    kmer_size: int = 17            # -k
    bin_size: int = 500            # -b  chaining bin width
    fixed_threshold: int = -1      # debug-only fixed alignment score cutoff
    xdrop: int = 7                 # -x
    split_count: int = 1           # --split-count  k-mer-space passes
    estimate_err: bool = False     # --estimate  (error rate from quals)
    skip_alignment: bool = False   # --skip-alignment  overlap-only output
    output_paf: bool = False       # --paf
    use_hopc: bool = False         # --hopc homopolymer-compressed k-mers
    delta_chernoff: float = 0.10   # --score-deviation
    total_memory_mb: float = 0.0   # -m  device budget; 0 = probe the card
    error_rate: float = 0.15       # -e
    hopc_error_rate: float = 0.035 # error rate used when use_hopc is on
    use_syncmer: bool = False      # -s
    use_minimizer: bool = False    # set when window_len > 0
    window_len: int = 0            # -w  minimizer window
    lower_freq: int = 2            # -l  reliable k-mer lower bound
    upper_freq: int = 8            # -u  reliable k-mer upper bound
    smer_len: int = 5              # syncmer s-mer length
    auto_bounds: bool = False      # --auto-bounds
    coverage: int = 0              # --coverage for --auto-bounds

    # --- aligner and device knobs ---
    band_width: int = 128          # band of the adaptive-band kernel (K2)
    aligner_backend: str = "auto"  # auto | pallas: static band; jax (any
                                   # other value): adaptive band
    pallas_band: int = 128         # static centered band of the first pass
                                   # (kernel K1; name kept from bella_tpu)
    band_rescue: bool = True       # re-extend band-saturated pairs through
                                   # the 2x-band cascade, then the adaptive
                                   # exactness tail
    rescue_predict: bool = True    # drift predictor routing of the cascade
    rescue_ceiling: int = 2048     # widest static rescue band (>= 2x
                                   # pallas_band is always tried)
    align_batch: int = 4096        # alignment pairs per batch of the plain
                                   # (CPU) kernels, and --selfcheck's K2
                                   # sample; on the card a level of pairs
                                   # is one launch, whatever its size
    max_steps: Optional[int] = None  # wavefront step cap; None: no cap
                                     # binds (t_len + q_len at most)
    selfcheck: bool = False        # --selfcheck  host recount, seed and
                                   # K1-against-K2 checks (utils/selfcheck.py)
    devices: int = 0               # --devices: shards (0/1 = one device)
    seed: int = 0                  # PRNG seed for synthetic generators
    write_matrix: Optional[str] = None  # dump reads x kmers matrix (bellaio)
    checkpoint: Optional[str] = None    # save/resume reliable triples (npz)
    profile_dir: Optional[str] = None   # torch.profiler trace directory

    def __post_init__(self):
        if self.kmer_size < 1 or self.kmer_size > 32:
            raise ValueError("kmer_size must be in [1, 32] (2-bit packed uint64)")
        if self.window_len:
            self.use_minimizer = True
        if self.use_syncmer:
            self.use_minimizer = False
        if not (0.0 <= self.delta_chernoff <= 1.0):
            raise ValueError("delta_chernoff must be in [0, 1]")

    @property
    def adaptive_aligner(self) -> bool:
        """True when alignment takes the adaptive-band path (K2 on every
        pair): aligner_backend is neither "auto" nor "pallas"."""
        return self.aligner_backend not in ("auto", "pallas")

    @property
    def effective_error_rate(self) -> float:
        """Error rate driving the adaptive threshold (src/main.cpp:307-314)."""
        return self.hopc_error_rate if self.use_hopc else self.error_rate

    @property
    def effective_memory_mb(self) -> float:
        """Device budget: the -m flag when given, else the card's memory
        (torch.cuda.mem_get_info), else the reference's 8 GB default."""
        if self.total_memory_mb > 0:
            return self.total_memory_mb
        if torch.cuda.is_available():
            return torch.cuda.mem_get_info()[1] / 1e6
        return 8000.0


def config_from_reference(d: dict) -> BellaConfig:
    """Map ``dataclasses.asdict(bella_tpu.BellaConfig(...))`` onto the
    port's config: the same fields carry across, the dropped ones
    (DROPPED_FIELDS) are ignored, anything else raises."""
    names = {f.name for f in dataclasses.fields(BellaConfig)}
    unknown = set(d) - names - set(DROPPED_FIELDS)
    if unknown:
        raise ValueError(f"fields unknown to the port: {sorted(unknown)}")
    return BellaConfig(**{k: v for k, v in d.items() if k in names})


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA (the default) raises when
    no card is present: the port never falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "kernels' plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
