"""Speed-up calculators.

Port of ``est_serial`` and ``calc_speedup`` from
``nngparareal_tpu/reporting.py``.
"""


def est_serial(run, N):
    """Estimated serial fine cost: per-slice fine time x N.

    run['timings']['F_time_serial_avg'] accumulates one per-slice fine
    time per iteration (K terms), so divide by K first.
    """
    k = max(run["k"], 1)
    return run["timings"]["F_time_serial_avg"] / k * N


def calc_speedup(run, N=None, serial=None):
    if serial is None:
        if N is None:
            raise Exception("Cannot compute speedup without either N or serial.")
        serial = est_serial(run, N)
    return serial / run["timings"]["runtime"]
