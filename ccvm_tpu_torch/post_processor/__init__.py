"""Post-processors: grad-descent, Adam, ASGD, BFGS and L-BFGS, the five
methods of the JAX package's factory."""

from ccvm_tpu_torch.post_processor.post_processor import MethodType, PostProcessor
from ccvm_tpu_torch.post_processor.factory import PostProcessorFactory
from ccvm_tpu_torch.post_processor.adam import PostProcessorAdam
from ccvm_tpu_torch.post_processor.asgd import PostProcessorASGD
from ccvm_tpu_torch.post_processor.bfgs import PostProcessorBFGS
from ccvm_tpu_torch.post_processor.grad_descent import PostProcessorGradDescent
from ccvm_tpu_torch.post_processor.lbfgs import PostProcessorLBFGS

__all__ = [
    "MethodType",
    "PostProcessor",
    "PostProcessorFactory",
    "PostProcessorAdam",
    "PostProcessorASGD",
    "PostProcessorBFGS",
    "PostProcessorGradDescent",
    "PostProcessorLBFGS",
]
