"""Seconds of set-up's first call: the cold preparation of the grid
(algorithm run, model, trace, device pack) and its first serve, by the
host clock around the call."""


def read(r):
    return r.get("cold_call_s")
