"""The benchmark's own roofline: the least work of a cell's measures for its
device rows' lengths. One module a measure (`<measure>.py`) names the
integer statistics the measure needs and the least operations of each
(`_counts.py`); `_bound.py` turns rows into the least time on the card of
`_peaks.py`."""
