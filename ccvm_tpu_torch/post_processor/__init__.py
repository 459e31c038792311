"""Post-processors (this slice: grad-descent; the others raise through the
factory, ROADMAP.md queue 1 item 8)."""

from ccvm_tpu_torch.post_processor.factory import PostProcessorFactory
from ccvm_tpu_torch.post_processor.grad_descent import PostProcessorGradDescent
from ccvm_tpu_torch.post_processor.post_processor import MethodType, PostProcessor

__all__ = [
    "MethodType",
    "PostProcessor",
    "PostProcessorFactory",
    "PostProcessorGradDescent",
]
