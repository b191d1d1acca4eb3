"""Monte Carlo samples completed in the window over the window's time.
A render's sample is one camera path traced to its end: width x height x
spp a frame."""


def read(record):
    return len(record["job_s"]) * record["samples_per_job"] / record["window_s"]
