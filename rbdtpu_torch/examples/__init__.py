"""Examples of the port, each runnable as a script (``python -m
rbdtpu_torch.examples.<name>``): ``mpc_reaching`` (batched DDP reaching
and closed-loop MPC with the arm), ``push_recovery`` (robust MPC under a
disturbance push on the rpy quadruped) and ``sharded_fleet`` (a scenario
fan sharded over ranks through ``distrib.launch``)."""
