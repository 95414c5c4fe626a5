"""The benchmark of esa_pose_estimation_tpu_torch on H100 cards."""
