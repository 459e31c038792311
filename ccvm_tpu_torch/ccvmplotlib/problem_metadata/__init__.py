from ccvm_tpu_torch.ccvmplotlib.problem_metadata.problem_metadata import (
    ProblemMetadata,
    ProblemType,
    TTSType,
)
from ccvm_tpu_torch.ccvmplotlib.problem_metadata.boxqp_metadata import BoxQPMetadata
from ccvm_tpu_torch.ccvmplotlib.problem_metadata.problem_metadata_factory import (
    ProblemMetadataFactory,
)

__all__ = [
    "ProblemMetadata",
    "ProblemType",
    "TTSType",
    "BoxQPMetadata",
    "ProblemMetadataFactory",
]
