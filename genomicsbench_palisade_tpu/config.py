"""Typed configuration for all kernels (SURVEY.md §5 config tier).

Replaces the reference's three config tiers (per-driver getopt flags,
Flye key=value .cfg files, Makefile build flags) with one dataclass tree.
`load_flye_cfg` reads the reference's key=value format (kmer_cnt.cpp:179
Config::load) for drop-in compatibility.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PhmmConfig:
    r_buckets: tuple = (64, 128, 256, 512)
    h_buckets: tuple = (128, 192, 256, 320, 384, 512)


@dataclass
class BswConfig:
    match: int = 1
    mismatch: int = 4
    gap_open: int = 6
    gap_extend: int = 1
    zdrop: int = 100
    end_bonus: int = 5
    ambig: int = -1
    w: int = 100
    batch: int = 512


@dataclass
class ChainConfig:
    max_dist_x: int = 5000
    max_dist_y: int = 5000
    bw: int = 500
    max_skip: int = 25
    max_iter: int = 5000


@dataclass
class FmiConfig:
    min_seed_len: int = 19
    split_width: int = 10
    max_mem_intv: int = 20
    split_factor: float = 1.5
    batch_size: int = 512
    m_cap: int = 96
    p_cap: int = 48


@dataclass
class KmerConfig:
    kmer_size: int = 17
    min_read_length: int = 5000
    saturation: int = 15
    use_minimizers: bool = False
    minimizer_window: int = 5


@dataclass
class PoaConfig:
    match: int = 2
    mismatch: int = -4
    gap_open1: int = -4
    gap_ext1: int = -2
    gap_open2: int = -24
    gap_ext2: int = -1

    @property
    def params(self):
        return (self.match, self.mismatch, self.gap_open1, self.gap_ext1,
                self.gap_open2, self.gap_ext2)


@dataclass
class AbeaConfig:
    bandwidth: int = 100
    kmer_size: int = 6
    min_average_log_emission: float = -5.0
    max_gap_threshold: int = 50


@dataclass
class MeshConfig:
    dp_axis: str = "dp"
    n_devices: int | None = None  # None = all local devices


@dataclass
class EngineConfig:
    phmm: PhmmConfig = field(default_factory=PhmmConfig)
    bsw: BswConfig = field(default_factory=BswConfig)
    chain: ChainConfig = field(default_factory=ChainConfig)
    fmi: FmiConfig = field(default_factory=FmiConfig)
    kmer: KmerConfig = field(default_factory=KmerConfig)
    poa: PoaConfig = field(default_factory=PoaConfig)
    abea: AbeaConfig = field(default_factory=AbeaConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def load_flye_cfg(path: str) -> dict:
    """Parse the Flye key=value config format (supports 'key = value' and
    continuation-free lines; comments start with ';' or '#')."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split(";")[0].split("#")[0].strip()
            if not line or "=" not in line:
                continue
            key, _, val = line.partition("=")
            val = val.strip()
            try:
                out[key.strip()] = int(val)
            except ValueError:
                try:
                    out[key.strip()] = float(val)
                except ValueError:
                    out[key.strip()] = val
    return out
