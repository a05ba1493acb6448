"""Entry points of the port: the LM server (``serve``), the "data" mesh
of spmd query execution (``mesh``) and the cluster-mode XQuery CLI
(``xquery_cluster``)."""
