"""The benchmark of ``spmv_vector_cache_tpu_torch`` on the card.

One command, ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; the cells are the ``workloads`` of
``BENCHMARK.json`` at the root of the repository.  See ``README.md``.
"""
