from ndt_feature_graph_tpu_torch.features.detector import FeatureSet, detect
from ndt_feature_graph_tpu_torch.features.descriptor import describe
from ndt_feature_graph_tpu_torch.features.distance import (
    symmetric_chi2_matrix,
)
from ndt_feature_graph_tpu_torch.features.ransac import (
    MatchResult, match_sets,
)
