from fmm_bem_tpu_torch.tree.morton import morton_encode, morton_decode
from fmm_bem_tpu_torch.tree.octree import Tree, build_tree

__all__ = ["morton_encode", "morton_decode", "Tree", "build_tree"]
