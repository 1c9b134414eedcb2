from fmm_bem_tpu_torch.traversal.lists import InteractionLists, build_interaction_lists

__all__ = ["InteractionLists", "build_interaction_lists"]
