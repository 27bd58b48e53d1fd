"""The share of the traced window, in %, in which no kernel, copy or
memset ran on the device, in the service's cells."""


def read(r: dict):
    s = r["summary"]
    if "service_after" not in r or s.window_us <= 0:
        return None
    return 100.0 * (1.0 - s.busy_us / s.window_us)
