"""Each job kind's driver, one module a kind, named by the traffic file's
``job``. A module defines ``Job(ctx)`` with

- ``run(i) -> (stages, least_s)``: job ``i`` of the window (``-1``: the
  warm-up) through the program's entry, returning the program's StageTimer
  seconds by stage and the job's least device time (``roofline/``);
- ``check(control=False) -> (checked, failed, numbers)``: after the window,
  the answers of the jobs it kept against the plain reference
  (``reference/``), or with ``control`` the reference in a lower precision
  in the program's place; ``failed`` counts the jobs whose answer is past
  a limit of the traffic's ``limits``, and ``numbers`` has each compared
  number under the name ``limits`` gives it.
"""
