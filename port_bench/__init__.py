"""The benchmark of the PyTorch and CUDA port (ndt_feature_graph_tpu_torch):
fleets of lidar robots served from one card.  Run a cell with
`python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the root of a checkout."""
