from ndt_feature_graph_tpu_torch.models.presets import (
    canonical_slam,
    feature_graph_slam,
    mcl_localizer,
    ndt_odometry,
    offline_mapper,
    p2d_registration,
)
