"""The share of the top-k's pairs that K23 ran the greedy match for, in %:
100 x counter "topk.greedy_pairs" (the pairs its screen kept, read back from
the device) over counter "topk.pairs" (Q x C pairs scored on the device),
summed over the calls. None where no call counted greedy pairs (a program
without the counter, or no K23 launch)."""


def read(rec):
    greedy = pairs = 0
    counted = False
    for c in rec.phased():
        counters = c.run_metrics.counters
        if "topk.greedy_pairs" in counters:
            counted = True
            greedy += counters["topk.greedy_pairs"]
            pairs += counters.get("topk.pairs", 0)
    return 100.0 * greedy / pairs if counted and pairs else None
