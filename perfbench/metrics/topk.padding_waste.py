"""The share of the pairs the top-k's lanes computed that carried no query,
in %: 1 - counter "topk.pairs" (Q x C pairs scored on the device) over
counter "topk.lane_pairs" (K23's launched threads times its candidates, plus
the plain route's pairs, which carry no padding), summed over the calls."""


def read(rec):
    pairs = lanes = 0
    for c in rec.phased():
        pairs += c.run_metrics.counters.get("topk.pairs", 0)
        lanes += c.run_metrics.counters.get("topk.lane_pairs", 0)
    return (1.0 - pairs / lanes) * 100.0 if lanes else None
