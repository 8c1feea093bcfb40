"""The predict workload of the port (`maze-ipp-torch predict|semseg|polytaxo`)."""
