from ccvm_tpu_torch.ccvmplotlib.utils.metric import Metric
from ccvm_tpu_torch.ccvmplotlib.utils.sampleTTSmetric import SampleTTSMetric

__all__ = ["Metric", "SampleTTSMetric"]
