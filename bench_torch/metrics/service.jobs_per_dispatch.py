"""Jobs over dispatches of the service's dispatcher in the window: how
many requests each render_batch call grouped."""


def read(r: dict):
    if "service_after" not in r:
        return None
    b, a = r["service_before"], r["service_after"]
    dispatches = a.get("dispatches", 0) - b.get("dispatches", 0)
    if dispatches <= 0:
        return None
    return (a.get("jobs", 0) - b.get("jobs", 0)) / dispatches
