"""Graph containers, partitioning, generators and the Tab. 1 stand-ins."""
