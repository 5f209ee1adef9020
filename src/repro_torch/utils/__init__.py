from repro_torch.utils.tree import param_count, tree_bytes, map_with_path
