"""Device time per traced round of the host-to-device and device-to-host
copies (ms)."""


def read(r):
    t = r.trace
    if t is None:
        return None
    us = [e.dur for e in t.device if e.cat == "gpu_memcpy"
          and ("HtoD" in e.name or "DtoH" in e.name)]
    return 1e-3 * sum(us) / t.rounds if us else None
