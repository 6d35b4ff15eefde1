"""Operation and byte counts of the port's kernels and models.

One module a kernel: ``count(*shape)`` gives the work of one call at those
shapes as ``{"bytes", "dot_flops", "lane_ops"}`` and ``KERNELS`` the
regular expression of its device operations' names in a trace
(``LAUNCHES_PER_CALL``, where present, the launches the port's counter
adds a call). What is
counted is what the function needs, whatever route implements it: each
input read once and each output written once; every multiply-add of a
dot product the function needs (2 operations); one lane operation per
candidate pair of a min or top-k and per output element of a relu or max.
``peaks.least_seconds`` turns a count into the least time on the card.
"""
