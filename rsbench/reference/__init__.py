"""The plain reference that decides ``correct``: the replayed edge set and
each query's answer in plain torch (:mod:`.graph`), and the comparison
with its limits (:mod:`.judge`, ``limits.json``).  It imports neither
JAX, nor the JAX package, nor the program."""
