"""Built-in workloads of the port: word count and k-means."""
