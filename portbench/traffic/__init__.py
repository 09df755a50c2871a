"""Traffic mixes (``<name>.json``, read by the driver their ``kind``
names) and their generators: seeded scenes, arrival schedules, the HTTP
load generator."""
