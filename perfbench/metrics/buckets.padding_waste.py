"""Padded char lanes over all char lanes of the device batches, summed over
buckets and calls (BucketMetrics: rows * width plus the rows added to round
the batch up, against the longer side's chars of each row), in %."""


def read(rec):
    total = useful = 0
    for c in rec.phased():
        for bm in c.run_metrics.buckets.values():
            total += bm.char_lanes + bm.padded_rows * bm.width
            useful += bm.useful_char_lanes
    return (1.0 - useful / total) * 100.0 if total else None
