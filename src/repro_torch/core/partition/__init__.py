# Subpackages are imported directly (repro_torch.core.partition.sfc etc.) — keep
# this __init__ empty to avoid import cycles with tree.py.
