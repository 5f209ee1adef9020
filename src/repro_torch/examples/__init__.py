"""The PyTorch twins of the repository's ``examples/``: the same
configurations and printouts, on the port.  Each runs as

    python -m repro_torch.examples.<name> [--device cpu]

on CUDA by default.  Each twin also prints the sets it sampled and the
final participation counts (one JSON line per run), so a run can be held
against the engines' own API."""
