"""Drivers of the program's entry points, one file an entry, named by a
mix's ``"entry"``.  Each module has ``Entry(cell, seed, device)`` with:

  tokens_per_call, flops_per_call   the work of one call (the model FLOPs
                                    from ``portbench.roofline``)
  setup()        weights, the program's state, every shape warmed up (a
                 training entry also takes its first steps here, the ones
                 the reference follows)
  call()         one call of the timed path, as the window drives it
  close()        drop the program's state (its judged outputs stay)
  judge_without_calls(n)   (an entry that judges calls of its window) draw
                 the judged calls as a window of ``n`` calls would, none
                 made, for the control's readings
  program()      what the program produced, for ``numbers``
  reference(p)   the same from the plain reference in precision ``p``
  numbers(a, b)  the compared numbers of ``a`` against the float32 ``b``
"""
