"""What this process did on the host while a window ran: its CPU seconds
(user and system) and its context switches, so that a slow run can be told
apart as one that waited (on the card, or for a CPU) from one whose host
work itself took longer.
"""

from __future__ import annotations

import resource


def sample() -> tuple:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, ru.ru_nvcsw, ru.ru_nivcsw


def since(before: tuple) -> dict:
    """The window's readings from `before` (a `sample()`) to now."""
    cpu, vol, invol = (a - b for a, b in zip(sample(), before))
    return {"self_cpu_s": cpu, "voluntary_switches": vol, "involuntary_switches": invol}
