"""DeServe's core mechanisms, own copies for the port: the §3 cost model,
the §4.2 offload formulas and double-buffer offloader, the §4.3 planner and
the Table 4 simulator."""
