"""``step_ms_max``: the slowest whole trainer step of the traced window
(host clock; a step ends when its loss has reached the host)."""


def read(rec):
    if not rec["steps"]:
        return None
    return max(b - a for a, b in rec["steps"]) / 1e6
