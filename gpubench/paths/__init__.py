"""Estimation paths: what a sample runs through in the program, and how its
result is judged. A configuration names its path (`"path": "<name>"`,
`em` where the key is absent) and the harness loads `paths/<name>.py` by
that name, as it loads a metric's reader. Each path module holds:

- `NUMBERS`: the names of the numbers it judges; a cell's `limits` name
  exactly these.
- `run_sample(inp, device, keep_values=True) -> sut.Sample`: the
  program's stages for one parsed sample (`sut.Inputs`), each inside
  `sut._span`, ending synchronised; `Sample.values` holds what `gaps`
  judges.
- `work(inp, sample) -> dict`: the sample's sizes for the yardstick
  (`yardstick.work.Work` fields; sizes that `Work` does not name are
  left to the path's own readers).
- `reference(ann, raw, config, device, precision)`: the plain reference
  of one distinct sample (`gen.synth` annotation and raw sample), at
  `precision` "reference", "stated" (the configuration's own precision)
  or "control" (one step lower). Its result has `values`, in the form of
  `Sample.values`, so that the control is judged as the program is, and
  may have `rounds`.
- `gaps(values, want, ann) -> Dict[str, float]`: one number for each name
  in `NUMBERS`, of a result's `values` against `want`, a result of
  `reference` at "reference".
"""

INTERFACE = ("NUMBERS", "run_sample", "work", "reference", "gaps")
DEFAULT = "em"
