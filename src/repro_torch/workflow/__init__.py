"""The DAGMan-analog grid workflow model: DAG, engine, execution
backends, site jobs and the workload registry."""
