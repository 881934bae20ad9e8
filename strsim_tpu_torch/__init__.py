"""strsim_tpu_torch: the tpu-strsim engine in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper GPU.

The five normalized similarity measures of polars-strsim (Levenshtein, Jaro,
Jaro-Winkler, Jaccard, Sorensen-Dice) and `strsim_tpu`'s nine extensions
(bigram Jaccard and Sorensen-Dice, cosine, overlap, Hamming, LCS, indel, OSA,
Soundex) over paired string columns, with f64 scores bit-for-float identical
to the reference and to `strsim_tpu`:

  strings -> codepoint tiles, int8 when ASCII (utils/encode.py, native/)
          -> length buckets, padded [B, L] int8/int32 batches, packed into
             pinned memory and uploaded (models/pipeline.py, native/)
          -> integer stats on the device (ops/stats.py: CUDA kernels in csrc/,
             their plain torch versions on CPU tensors)
          -> exact f64 finalize on the host (native/, ops/finalize.py).

The native host layer (native/: a C++ library built with g++ at first use)
encodes, packs, finalizes, scores the host rows and gives bench_torch.py its
single-core baseline.

The default config runs on "cuda" and raises without a GPU; pass
StrsimConfig(device="cpu") to run the plain torch versions. This package
never imports jax or strsim_tpu.
"""
from strsim_tpu_torch.api import (
    Literal,
    compute,
    compute_many,
    compute_with_validity,
    cosine,
    hamming,
    indel,
    jaccard,
    jaccard_bigram,
    jaro,
    jaro_winkler,
    lcs_seq,
    levenshtein,
    lit,
    osa,
    overlap,
    sorensen_dice,
    sorensen_dice_bigram,
    soundex,
    top_k_matches,
)
from strsim_tpu_torch.config import StrsimConfig, get_config, set_config
from strsim_tpu_torch.models.measures import MEASURES

__all__ = [
    "levenshtein",
    "jaro",
    "jaro_winkler",
    "jaccard",
    "sorensen_dice",
    "jaccard_bigram",
    "sorensen_dice_bigram",
    "cosine",
    "overlap",
    "hamming",
    "lcs_seq",
    "indel",
    "osa",
    "soundex",
    "compute",
    "compute_many",
    "compute_with_validity",
    "top_k_matches",
    "lit",
    "Literal",
    "StrsimConfig",
    "get_config",
    "set_config",
    "MEASURES",
]
