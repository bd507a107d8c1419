"""Model families: what the harness needs to know of a configuration's model.

A configuration file names its family (`"family": "latent"`, no default);
`Spec.family` loads `families/<family>.py` from the directories given first,
then from `portbench/`. The harness reads a configuration's model only
through these functions of the family's module, so a model of another
family comes in as new files alone (a configuration, a family module, a
mix, readers):

- `make(cfg, seed, device) -> (params, stats)`: the seeded weights, made on
  `device` from the seed; called again, with the same seed, for the
  reference after the window.
- `build_service(cfg, params, stats, device)`: the port's service, an object
  with `buckets`, `request_plan(n)`, `warmup(seed, buckets=...)` and
  `sample_async(classes, seed, colors=None, decode=True) -> fetch` (the
  port's `SamplingService`, `PixelSamplingService` and `CoalescingBatcher`
  speak it).
- `conditions(cfg) -> dict`: what each image of a request carries, among
  `classes` and `colors` (the service's arguments), each with how many
  values it takes: `{"classes": 102}`, `{"classes": 102, "colors": 10}`; a
  count of None is not drawn (`{"classes": None}`: an unconditional family,
  its requests carry class 0 for each image, which only counts them).
- `reference(params, stats, cfg, picks, precision) -> uint8 images`: for each
  placed request `(dispatch, first row, n)` the reference's images of the
  dispatch's rows first .. first + n - 1, stacked in the order of `picks`,
  at `precision` "program" (the precision the configuration states) or
  "control" (one step lower). A dispatch has `seed`, `classes` and `colors`
  (None where the call passed none) as `sample_async` was called; the
  family's own chunk and seed semantics stay in its module.
- `image_flops(cfg)`: the model operations of one delivered image.
"""
