"""The randomized differential soak's subprocess discipline: its head only.

The reference's ``tools/soak.py`` runs every chaos config in a subprocess
with a wall timeout and one retry after exponential backoff. The fleet
(``serve/fleet.py``) spawns its workers with the same ladder and reads its
two constants from here. The soak itself (the seeded config draws, the
numpy / native / oracle legs, chaos mode and its checkpoint) is not ported
yet: it comes with the load drivers (``loadgen``, ``hostile``), ROADMAP
Queue 1 item 6b.
"""

#: Wall-clock budget of one subprocess attempt (a chaos child, or a fleet
#: worker's ready-or-timeout ladder).
CHAOS_TIMEOUT_S = 180.0
#: Base of the exponential backoff before a retry (``CHAOS_BACKOFF_S *
#: 2**attempt``).
CHAOS_BACKOFF_S = 0.5
