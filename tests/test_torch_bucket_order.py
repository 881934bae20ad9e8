"""`pipeline.bucket_rows`, one native counting pass (`binding.order_rows`),
against the composition it replaced, kept here as the reference: each
device row's bucket by np.unique / searchsorted over `StrsimConfig.bucket_for`,
one boolean mask a bucket, then each bucket's stable argsort on la + lb.
The keys come in the same order and every bucket's rows are element-equal;
and the ladder's lookup table gives what `bucket_for` gives for every
length."""
import numpy as np
import pytest

from strsim_tpu_torch.config import StrsimConfig
from strsim_tpu_torch.models import pipeline as tpipe

LADDER = StrsimConfig().buckets


def reference_rows(idx, la, lb, cfg):
    """The partition and the per-bucket length sort as the pipeline had them."""
    if not idx.size:
        return {}
    maxlen = np.maximum(la[idx], lb[idx])
    uniq = np.unique(maxlen)
    uniq_bucket = np.array([cfg.bucket_for(int(v)) for v in uniq], dtype=np.int64)
    bucket_of = uniq_bucket[np.searchsorted(uniq, maxlen)]
    out = {}
    for w in np.unique(bucket_of):
        sel = idx[bucket_of == w]
        if w >= 0:  # the host rows were never sorted
            sel = sel[np.argsort(la[sel].astype(np.int64) + lb[sel], kind="stable")]
        out[int(w)] = sel
    return out


def _lengths(rng, n, choices):
    la = rng.choice(choices, n).astype(np.int32)
    lb = rng.choice(choices, n).astype(np.int32)
    return la, lb


def _case(name):
    """(idx, la, lb, cfg) of one case; idx ascending int64, as classify gives it."""
    rng = np.random.default_rng(CASES.index(name))
    cfg = StrsimConfig(device="cpu")
    n = 20_000
    if name == "ladder_1_to_27":
        la, lb = _lengths(rng, n, np.arange(1, 28))
    elif name == "ladder_edges":
        edges = np.array(LADDER)
        la, lb = _lengths(rng, n, np.concatenate([edges, edges + 1, [1, 2]]))
    elif name == "extend_past_511":
        la, lb = _lengths(rng, n, np.concatenate([np.arange(1, 40), np.arange(500, 4200, 7)]))
    elif name == "oracle_past_511":
        la, lb = _lengths(rng, n, np.concatenate([np.arange(1, 40), np.arange(505, 900)]))
        cfg = cfg.replace(overflow_policy="oracle")
    elif name == "past_max_extend_len":
        la, lb = _lengths(rng, n, np.concatenate([np.arange(1, 30), [8191, 8192, 16383, 16384,
                                                                     16385, 20000]]))
    elif name == "past_a_small_max_extend_len":
        la, lb = _lengths(rng, n, np.arange(1, 1400, 3))
        cfg = cfg.replace(max_extend_len=600)
    elif name == "other_ladder":
        la, lb = _lengths(rng, n, np.arange(1, 200))
        cfg = cfg.replace(buckets=(8, 16))
    elif name == "unsorted_ladder":
        la, lb = _lengths(rng, n, np.arange(1, 700))
        cfg = cfg.replace(buckets=(31, 7, 15))
    elif name == "empty":
        la, lb = _lengths(rng, 10, np.arange(1, 28))
        return np.zeros(0, np.int64), la, lb, cfg
    elif name == "single_row":
        la, lb = _lengths(rng, 10, np.arange(1, 28))
        return np.array([4], np.int64), la, lb, cfg
    elif name == "one_length":
        la = lb = np.full(n, 12, np.int32)
    elif name == "gapped_idx":
        la, lb = _lengths(rng, n, np.arange(1, 64))
        idx = np.sort(rng.choice(np.arange(137, n), 5_000, replace=False)).astype(np.int64)
        return idx, la, lb, cfg
    else:
        raise KeyError(name)
    return np.arange(n, dtype=np.int64), la, lb, cfg


CASES = ("ladder_1_to_27", "ladder_edges", "extend_past_511", "oracle_past_511",
         "past_max_extend_len", "past_a_small_max_extend_len", "other_ladder", "unsorted_ladder",
         "empty", "single_row", "one_length", "gapped_idx")


@pytest.mark.parametrize("name", CASES)
def test_bucket_rows_equals_the_masks_and_the_stable_sort(name):
    idx, la, lb, cfg = _case(name)
    got, want = tpipe.bucket_rows(idx, la, lb, cfg), reference_rows(idx, la, lb, cfg)
    assert list(got) == list(want)
    for w in want:
        assert got[w].dtype == want[w].dtype and np.array_equal(got[w], want[w]), w
    if name in ("oracle_past_511", "past_max_extend_len", "past_a_small_max_extend_len"):
        assert list(got)[0] == -1  # rows beyond the ladder, in row order
    if name == "extend_past_511":
        assert max(got) > 511 and -1 not in got


CONFIGS = {
    "default": StrsimConfig(),
    "oracle": StrsimConfig(overflow_policy="oracle"),
    "max_extend_600": StrsimConfig(max_extend_len=600),
    "max_extend_below_the_ladder": StrsimConfig(max_extend_len=100),
    "ladder_8_16": StrsimConfig(buckets=(8, 16)),
    "unsorted_ladder": StrsimConfig(buckets=(31, 7, 15)),
}


@pytest.mark.parametrize("name", CONFIGS)
def test_lookup_table_gives_what_bucket_for_gives(name):
    """widths[rank_of[m]] is bucket_for(m) for every length 0..M of the
    table, and bucket_for gives -1 for every length past it."""
    cfg = CONFIGS[name]
    widths, rank_of = tpipe.bucket_ranks(cfg.buckets, cfg.overflow_policy, cfg.max_extend_len)
    got = [int(widths[rank_of[m]]) for m in range(rank_of.size)]
    assert got == [cfg.bucket_for(m) for m in range(rank_of.size)]
    assert all(cfg.bucket_for(m) == -1 for m in range(rank_of.size, rank_of.size + 70))
    assert widths[0] == -1 and np.all(np.diff(widths) > 0)
    assert not widths.flags.writeable and not rank_of.flags.writeable
    if name == "default":
        assert rank_of.size == 16384 and int(widths[-1]) == 16383


def test_a_call_stages_each_bucket_in_bucket_rows_order(monkeypatch):
    """Through compute_scores: each bucket is staged in bucket_rows' order,
    so the staged lengths rise within every bucket."""
    cfg = StrsimConfig(device="cpu", host_short_circuit_rows=8)
    rng = np.random.default_rng(3)
    letters = np.array(list("abcdefghij"))
    a = ["".join(rng.choice(letters, k)) for k in rng.integers(1, 40, 3000)]
    b = ["".join(rng.choice(letters, k)) for k in rng.integers(1, 40, 3000)]
    staged = []
    real = tpipe.stage_bucket

    def spy(measures, a_, b_, la, lb, sel, width, *args, **kwargs):
        out = real(measures, a_, b_, la, lb, sel, width, *args, **kwargs)
        staged.append((width, la[out["sel"]].astype(np.int64) + lb[out["sel"]], out["sel"]))
        return out
    monkeypatch.setattr(tpipe, "stage_bucket", spy)
    tpipe.compute_scores(a, b, ("levenshtein",), config=cfg)
    assert [w for w, _, _ in staged] == sorted(w for w, _, _ in staged) and len(staged) >= 3
    for width, sums, sel in staged:
        assert np.all(np.diff(sums) >= 0), width
        ties = np.diff(sums) == 0
        assert np.all(np.diff(sel)[ties] > 0), width  # ties in row order
