"""Scale-out over several devices: the worlds-sharded planner (batch.py)
and its dry runs (dryrun.py)."""
