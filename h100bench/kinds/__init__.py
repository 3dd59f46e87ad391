"""Traffic kinds: the code that drives one entry point of the program.  A
traffic file (traffic/<mix>.json) names its kind and holds its
parameters; the harness loads kinds/<kind>.py by that name and calls its
class `Kind(config, traffic, seed, device, root, log)` in this order:

  setup()            inputs from the seed, the program's state, warm-up
                     of every shape the window uses;
  window(seconds, rec)
                     the measured window: its calls into the program in
                     rec.span(name), rec.step(i) at each step and
                     rec.step(n, final=True) at the end; sets `seconds`
                     (the window's length) and `attempted`;
  end_to_end()       {metric: value} of the untraced run;
  work()             {span name: work.msm_work(...)} for roofline readers;
  counters()         {name: value} measured after a traced window;
  release()          frees the program's state (the peak is read first);
  check()            [(name, number, limit)] against the reference; sets
                     `failed`.
"""
