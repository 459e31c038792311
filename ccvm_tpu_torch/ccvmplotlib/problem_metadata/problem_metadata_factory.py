"""Problem-metadata factory (parity with
``ccvm_simulators/ccvmplotlib/problem_metadata/problem_metadata_factory.py``;
a copy of ``ccvm_tpu/ccvmplotlib/problem_metadata/problem_metadata_factory.py``)."""

from ccvm_tpu_torch.ccvmplotlib.problem_metadata.boxqp_metadata import BoxQPMetadata
from ccvm_tpu_torch.ccvmplotlib.problem_metadata.problem_metadata import (
    ProblemMetadata,
    ProblemType,
)


class ProblemMetadataFactory:
    """Create a problem-specific metadata object."""

    @staticmethod
    def create_problem_metadata(problem: str) -> ProblemMetadata:
        """Map a problem-type string to its Metadata class.

        Raises:
            AssertionError: If an unsupported problem is given.
        """
        if ProblemType(problem) == ProblemType.BoxQP:
            return BoxQPMetadata(ProblemType(problem))
        raise AssertionError(f'"{problem}" problem type is not supported.')
