"""The intersector kernels' share of their roofline, in %: the least time
of the frames' intersection queries over the kernels' device time.

The least time is bound by bytes: each query moves its active rays in
(origin, direction, t_max: 28 B), their hits out (t and triangle: 8 B;
any-hit: 4 B), and reads the scene's triangles once (36 B each), at the
card's HBM bandwidth (``peaks.json``).  This counts the work a query
needs, whatever implements it: a change to the cull or the tree leaves
it as it is."""

RAY_IN = 28
HIT_OUT = {"nearest": 8, "any": 4}
TRI = 36


def read(record):
    peaks = record.get("peaks")
    isect = set(record["isect_kernels"])
    kernel_us = sum(o["dur"] for o in record["trace"]["ops"]
                    if o["kernel"] in isect)
    if not peaks or not kernel_us or not record["queries"]:
        return None
    nbytes = sum(q["rays"] * (RAY_IN + HIT_OUT[kind])
                 + q["queries"] * record["num_triangles"] * TRI
                 for kind, q in record["queries"].items())
    least_s = nbytes / peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (kernel_us / 1e6)
