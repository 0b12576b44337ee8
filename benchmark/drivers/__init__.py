"""The drivers: each builds one kind of program and drives it through a
cell's run. A configuration file names its driver under ``"driver"``
(``"pipeline"`` where it names none), and the harness finds
``drivers/<driver>.py`` by that name (``harness.cell.driver``), as it
finds ``metrics/<metric>.py``. A new kind of program comes as a new
driver file, with its plain reference and its configuration; no file of
``harness/`` changes for it.

A driver module gives:

- ``ENTRIES``: {traffic entry: the batch sizes it takes, as a tuple, or
  None for any}. A traffic file's ``entry`` and ``batch`` must be among
  them, or the run raises ValueError before it starts.
- ``NAMES``: the names of the numbers ``compare`` returns; a configuration
  of this driver has a limit for each under ``"limits"``, and no other.
- ``build(config, rig, device)``: the program on the configuration's
  settings, ``rig`` being ``harness.inputs.rig``'s matrices.
- ``call(program, entry, pool, seq, batch)``: the call the window drives
  for ``entry``, ``fn(slot, pairs) -> out``; ``pool`` is the
  (lefts, rights) host uint8 frames, ``seq`` the pool order, whose
  ``slot``-th ``batch`` entries are ``pairs``. What the call's slots
  need (stacked batches) is made here, before the window.
- ``fetch(out)``: the host's result of one call, indexable by the
  frame's place in the call; it is kept as ``Call.stats``. The window
  times each call to the end of its fetch.
- ``holder(entry, checked, seed)``: an object with ``prepare(out)``
  (given the last warm-up's ``out``, before the window: allocate what
  holding needs), ``offer(pairs, out)`` (inside the window, after each
  call: keep a copy of some frame's outputs of each checked pair,
  allocating nothing) and ``frames()`` (after the window: [(pool pair,
  its kept outputs)], sorted by pair).
- ``compare(held, fetched, pool, rig, config, device)``: {name: number}
  for ``NAMES``, each the worst over the checked frames, from the
  driver's own plain reference run on the same host frames. ``held`` is
  ``frames()``, ``fetched`` [(pool pair, its frame's item of a fetch)]
  for every fetched frame of a checked pair. It runs after the window,
  once the program is freed.

``harness/check.judge`` holds the numbers against the configuration's
``limits``.
"""
