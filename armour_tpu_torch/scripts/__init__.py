"""The system's scripts (counterparts of the JAX package's scripts/), each
runnable as ``python3 -m armour_tpu_torch.scripts.<name>``:

  * stuck_lab             - the closed-loop variant sweep over a suite's
                            stuck worlds, on the card;
  * derive_ub_cache       - writes models/ub_cache.json (host float64);
  * regenerate_unsolvable - replaces the scenes a solvability verdict marks
                            impossible, in place;
  * extract_robot_zoo     - builds models/zoo_data.json from the reference
                            URDFs and meshes.

Each module has one function and a main(argv=None) that takes the JAX
script's positional arguments and defaults."""
