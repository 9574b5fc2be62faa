"""Multi-device runs: the (data, model) mesh over a torch.distributed group
(mesh.py) and the multichip dry run (dryrun.py)."""
