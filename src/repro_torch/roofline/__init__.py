"""Roofline of the port on one NVIDIA H100: the record and its terms
(``analysis``), the dispatch-level cost model (``op_cost``), collective
traffic (``collectives``), tables (``report``) and re-analysis of archived
op traces (``reanalyze``)."""
