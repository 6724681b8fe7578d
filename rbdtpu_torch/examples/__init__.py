"""Examples of the port, each runnable as a script: ``push_recovery``
(robust MPC under a disturbance push on the rpy quadruped)."""
