"""One module a drive, found by a traffic mix's `drive` key
(registry.drive): how a kind of input is made, fed to the program and
judged. A drive defines

  jobs(cfg, mix, seed) -> list         the sequences' jobs, for this seed;
  sequence(*job) -> (inputs, gt)       one sequence: the program's inputs
                                       (a tuple) and its ground truth;
  Program(cfg, device, spans)          the system under test, with
      .run(*inputs) -> record          a dict holding at least `poses` and
                                       `icp_iters` (the harness adds `seq`
                                       and `frames` = len(inputs[0]));
  reference(cfg, mix, inputs, rec, device, precision) -> ref
                                       the plain reference on the same
                                       inputs (slambench/reference);
  numbers(rec, ref, gt) -> dict        the compared numbers of a record;
  key(rec) -> tuple                    what its reference depends on;
  FAULTS                               {name: cfg -> (the program's
                                       configuration, a patch in force
                                       while it is built and runs)}, the
                                       faults planted in the program;

and may define summary(rec or ref) -> dict, counts that
slambench/calibrate.py prints beside its readings. `jobs` and `sequence`
run in workers forked before torch loads, so a drive imports neither torch
nor the program at module level.
"""
