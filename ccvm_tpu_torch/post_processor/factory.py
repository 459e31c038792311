"""Post-processor factory (API-parity port of
``ccvm_simulators/post_processor/factory.py``)."""

from __future__ import annotations

from ccvm_tpu_torch.post_processor.grad_descent import PostProcessorGradDescent
from ccvm_tpu_torch.post_processor.post_processor import MethodType

# Methods of the reference whose port is still to come.
_NOT_PORTED = (MethodType.BFGS, MethodType.LBFGS, MethodType.Adam, MethodType.ASGD)


class PostProcessorFactory:
    """The Factory Class (reference ``factory.py:9-35``)."""

    @staticmethod
    def create_postprocessor(method):
        """Create the relevant post processor from the given method name.

        Raises:
            NotImplementedError: the method is not ported yet.
            AssertionError: Invalid method type is provided.
        """
        name = method.lower()
        if name == MethodType.GradDescent.value:
            return PostProcessorGradDescent()
        if name in {m.value for m in _NOT_PORTED}:
            raise NotImplementedError(
                f"post-processor {method!r} is not ported to ccvm_tpu_torch yet "
                "(ROADMAP.md, queue 1 item 8)"
            )
        raise AssertionError(f"Method type is not valid. Provided: {method}")
