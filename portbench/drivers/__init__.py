"""One driver a mode (``drivers/<mode>.py``), found by the cell's
``mode``.  A driver module defines ``Driver(cell, cfg, seed, seconds,
device, backend_map)``: its constructor is the set-up, ``window(range)``
the measured window, ``close()`` frees the program's state,
``check()`` compares the timed path with the plain reference, and
``control(kind)`` reads the same numbers with the reference, run as
``kind`` says, in the program's place."""
