"""The TAMUNA-DP round on one GPU: the client workspace, the local and comm
steps, and the synchronous round driver."""
