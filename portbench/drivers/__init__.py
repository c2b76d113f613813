"""The general generators, one per traffic ``kind``: each reads its
cell's configuration and traffic files and drives the port's entry for
that kind of work. A driver has ``unit`` (what a call completes),
``cycle`` (calls that make one whole turn of the traffic), ``call(i)``
(one timed call; returns the units done), ``synchronize()``,
``flops_per_unit()`` (the work on need, counted by the benchmark),
``release()`` (frees the program's state), ``check()`` (the numbers the
reference compares) and ``failed(checks)``."""
