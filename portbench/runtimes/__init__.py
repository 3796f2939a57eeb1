"""Runtimes the traffic mixes name (``"runtime"`` in a mix's file), one
module each, found by that name. A training runtime gives ``Program``
(the program's object the window times: ``step``, ``watch_gradient``,
``first_gradient``, ``served``, ``close``), ``warm_up`` (set-up's
checked steps and the program's readings), ``reference`` (the plain
reference's readings of the same steps), ``compare`` (the numbers held
to a cell's limits) and ``tokens`` (what a step trains and runs forward
only, for MFU)."""
