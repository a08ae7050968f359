"""Built-in workloads of the port: word count and device-resident k-means."""
