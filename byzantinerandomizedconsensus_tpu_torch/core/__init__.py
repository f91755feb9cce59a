"""The object oracle: Replica, Network, Adversary, FaultSchedule and the
Simulator front end.

The port's copy of the reference's ``core/``: an implementation of
spec/PROTOCOL.md independent of the vectorized torch model layer, scalar per
instance and per replica, so the bit-match against it checks two different
code paths. It draws from its own PRF on Python ints and numpy arrays
(``core/prf.py``).
"""
