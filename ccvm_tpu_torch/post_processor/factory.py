"""Post-processor factory (API-parity port of
``ccvm_simulators/post_processor/factory.py`` by way of
``ccvm_tpu/post_processor/factory.py``)."""

from __future__ import annotations

from ccvm_tpu_torch.post_processor.adam import PostProcessorAdam
from ccvm_tpu_torch.post_processor.asgd import PostProcessorASGD
from ccvm_tpu_torch.post_processor.bfgs import PostProcessorBFGS
from ccvm_tpu_torch.post_processor.grad_descent import PostProcessorGradDescent
from ccvm_tpu_torch.post_processor.lbfgs import PostProcessorLBFGS
from ccvm_tpu_torch.post_processor.post_processor import MethodType

_CLASSES = {
    MethodType.BFGS.value: PostProcessorBFGS,
    MethodType.LBFGS.value: PostProcessorLBFGS,
    MethodType.Adam.value: PostProcessorAdam,
    MethodType.ASGD.value: PostProcessorASGD,
    MethodType.GradDescent.value: PostProcessorGradDescent,
}


class PostProcessorFactory:
    """The Factory Class (reference ``factory.py:9-35``)."""

    @staticmethod
    def create_postprocessor(method):
        """Create the relevant post processor from the given method name.

        Raises:
            AssertionError: Invalid method type is provided.
        """
        cls = _CLASSES.get(method.lower())
        if cls is None:
            raise AssertionError(f"Method type is not valid. Provided: {method}")
        return cls()
