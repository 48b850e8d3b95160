"""Command line interface (reference parity: ``floodsr/cli.py``).

Port of the JAX package's ``cli.py``; run it as
``python -m floodsr_tpu_torch.cli``. Same argparse tree and flag surface as
the reference — ``tohr`` (with the machine-interface JSON),
``models {list,fetch}``, ``doctor`` — plus ``cache {info,purge}`` (the
lifecycle surface the reference ADR-0012 spec'd but never built) and
``serve``. ``doctor`` reports the PyTorch/CUDA runtime in the same
machine-parseable ``key=value`` style; it, ``models`` and ``cache`` touch no
device. ``tohr`` and ``serve`` run on the GPU (``--device cuda``, the default,
which fails without CUDA) or on the CPU when asked (``--device cpu``), and
take the JAX package's mesh options: ``--mesh SPEC`` spreads the work over
the visible GPUs (one CPU with ``--device cpu``), ``--scene-mode`` picks the
replicated or banded scene.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from pathlib import Path

from floodsr_tpu_torch.cache_paths import get_model_cache_path
from floodsr_tpu_torch.cache_policy import cache_info, cache_purge
from floodsr_tpu_torch.checksums import verify_sha256
from floodsr_tpu_torch.model_registry import (
    fetch_model,
    list_models,
    list_runnable_model_versions,
    load_models_manifest,
    model_worker_exists,
)
from floodsr_tpu_torch.tohr import tohr, tohr_many

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------


def _resolve_log_level(args: argparse.Namespace) -> int:
    """Effective level: --log-level verbatim, else INFO shifted by -v/-q.

    Each -v steps one level louder, each -q one quieter; the result never
    leaves the DEBUG..ERROR band.
    """
    if args.log_level is not None:
        return getattr(logging, args.log_level)
    ladder = (logging.DEBUG, logging.INFO, logging.WARNING, logging.ERROR)
    base = ladder.index(logging.INFO)
    rung = base - int(args.verbose) + int(args.quiet)
    return ladder[min(max(rung, 0), len(ladder) - 1)]


def _configure_logging(args: argparse.Namespace) -> None:
    level = _resolve_log_level(args)
    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig(level=level)
    root.setLevel(level)


# ---------------------------------------------------------------------------
# tohr model-spec resolution
# ---------------------------------------------------------------------------


def _verified_cache_hit(version: str, payload: dict, cache_dir) -> Path | None:
    """The cached artifact path for a manifest entry, iff present and digest-valid."""
    candidate = get_model_cache_path(version, payload["file_name"], cache_dir=cache_dir)
    if candidate.exists() and verify_sha256(candidate, payload["sha256"]):
        return candidate
    return None


def _resolve_tohr_model_spec(args: argparse.Namespace) -> tuple[str, Path]:
    """Pick (version, artifact path) for a tohr run.

    Precedence ladder: an explicit ``--model-path`` always wins (paired with
    ``--model-version`` when given, else the first runnable manifest
    version); a bare ``--model-version`` triggers a (cache-aware) fetch; with
    neither, the first digest-valid cached runnable model is used.
    """
    explicit_version = args.model_version
    if explicit_version is not None and not model_worker_exists(explicit_version):
        raise ValueError(f"no model worker found for --model-version={explicit_version}")

    if args.model_path is not None:
        artifact = Path(args.model_path).expanduser().resolve()
        assert artifact.exists(), f"model path does not exist: {artifact}"
        if explicit_version is not None:
            return explicit_version, artifact
        runnable = list_runnable_model_versions(manifest_fp=args.manifest)
        assert runnable, "manifest has no runnable model entries"
        return runnable[0], artifact

    if explicit_version is not None:
        artifact = fetch_model(
            explicit_version,
            cache_dir=args.cache_dir,
            manifest_fp=args.manifest,
            backend_name=args.backend,
            force=args.force,
        )
        return explicit_version, artifact

    entries = load_models_manifest(manifest_fp=args.manifest)
    assert entries, "manifest has no model entries"
    runnable = [v for v in entries if model_worker_exists(v)]
    assert runnable, "manifest has no runnable model entries (worker module missing)"
    for version in runnable:
        hit = _verified_cache_hit(version, entries[version], args.cache_dir)
        if hit is not None:
            return version, hit
    raise FileNotFoundError(
        "no cached runnable model found and --model-version was not provided. "
        "run `floodsr models fetch <model_version>` or pass --model-path."
    )


# ---------------------------------------------------------------------------
# machine-interface JSON
# ---------------------------------------------------------------------------

# tohr machine-json schema: normalized key -> (CLI flag, is_switch).
# Keep aligned with the tohr subparser options in _parse_arguments().
_MACHINE_SCHEMA: dict[str, tuple[str, bool]] = {
    "in": ("--in", False),
    "in_fp": ("--in", False),
    "dem": ("--dem", False),
    "fetch_hrdem": ("--fetch-hrdem", True),
    "fetch_out": ("--fetch-out", False),
    "fetch_res": ("--fetch-res", False),
    "out": ("--out", False),
    "model_version": ("--model-version", False),
    "model_path": ("--model-path", False),
    "manifest": ("--manifest", False),
    "cache_dir": ("--cache-dir", False),
    "backend": ("--backend", False),
    "force": ("--force", True),
    "max_depth": ("--max-depth", False),
    "dem_pct_clip": ("--dem-pct-clip", False),
    "window_method": ("--window-method", False),
    "tile_overlap": ("--tile-overlap", False),
    "tile_size": ("--tile-size", False),
    "input_kind": ("--input-kind", False),
    "buildings": ("--buildings", False),
    "fetch_buildings": ("--fetch-buildings", True),
    "mesh": ("--mesh", False),
    "scene_mode": ("--scene-mode", False),
    "output_compress": ("--output-compress", False),
    "device": ("--device", False),
}


def _scan_argv(argv: list[str], flag: str) -> tuple[bool, str | None]:
    """(present, value) for ``flag`` in raw argv; handles both token styles."""
    prefix = flag + "="
    for position, token in enumerate(argv):
        if token == flag:
            value = argv[position + 1] if position + 1 < len(argv) else None
            return True, value
        if token.startswith(prefix):
            return True, token[len(prefix):]
    return False, None


def _read_tohr_machine_json(machine_json_fp: Path) -> dict[str, object]:
    """Parse the machine-interface file; a nested ``"tohr"`` object is unwrapped."""
    source = machine_json_fp.expanduser().resolve()
    assert source.exists(), f"machine json does not exist: {source}"
    document = json.loads(source.read_text(encoding="utf-8"))
    assert isinstance(document, dict), f"machine json must be an object: {source}"
    body = document.get("tohr", document)
    assert isinstance(body, dict), f"machine json 'tohr' payload must be an object: {source}"
    return body


def _build_tohr_machine_cli_tokens(payload: dict[str, object], argv: list[str]) -> list[str]:
    """Expand a machine-json payload into extra argv tokens.

    Flags the user already typed are skipped (explicit CLI wins); switch keys
    must be JSON booleans; unknown keys are an error rather than a silent drop.
    """
    extra: list[str] = []
    for raw_key, value in payload.items():
        key = raw_key.strip().lstrip("-").replace("-", "_")
        try:
            flag, is_switch = _MACHINE_SCHEMA[key]
        except KeyError:
            raise ValueError(f"unsupported tohr machine-json key: {raw_key}") from None
        already_given, _ = _scan_argv(argv, flag)
        if already_given:
            continue
        if is_switch:
            if not isinstance(value, bool):
                raise ValueError(
                    f"machine-json key '{raw_key}' must be boolean, got {type(value)!r}"
                )
            if value:
                extra.append(flag)
        elif value is not None:
            extra += [flag, str(value)]
    return extra


def _inject_tohr_machine_json_args(argv: list[str] | None) -> list[str] | None:
    """Pre-pass over argv: splice in tokens from --machine-json for `tohr`."""
    tokens = list(sys.argv[1:]) if argv is None else list(argv)
    if tokens[:1] != ["tohr"]:
        return tokens
    _, json_fp = _scan_argv(tokens, "--machine-json")
    if json_fp is None:
        return tokens
    payload = _read_tohr_machine_json(Path(json_fp))
    return tokens + _build_tohr_machine_cli_tokens(payload, tokens)


def _resolve_default_output_path(in_fp: Path) -> Path:
    """Default output: ``./<input stem>_sr<input ext>`` in the working directory."""
    source = Path(in_fp).expanduser()
    return (Path.cwd() / (source.stem + "_sr" + (source.suffix or ".tif"))).resolve()


# ---------------------------------------------------------------------------
# command routing
# ---------------------------------------------------------------------------


def _cmd_models_list(args: argparse.Namespace) -> int:
    for record in list_models(manifest_fp=args.manifest):
        print(f"{record.version}\t{record.file_name}\t{record.url}")
    return 0


def _cmd_models_fetch(args: argparse.Namespace) -> int:
    print(
        fetch_model(
            args.version,
            cache_dir=args.cache_dir,
            manifest_fp=args.manifest,
            backend_name=args.backend,
            force=args.force,
        )
    )
    return 0


def _cmd_tohr(args: argparse.Namespace) -> int:
    if args.fetch_out is not None and not args.fetch_hrdem:
        raise ValueError("--fetch-out requires --fetch-hrdem")
    if args.fetch_res is not None:
        if not args.fetch_hrdem:
            raise ValueError("--fetch-res requires --fetch-hrdem")
        if args.fetch_res <= 0:
            raise ValueError(f"--fetch-res must be positive, got {args.fetch_res}")

    # Layered defaults (ADR-0011 pattern): CLI > env > user config file.
    from floodsr_tpu_torch.config import load_config

    config = load_config()
    if args.cache_dir is None and config.cache_dir:
        args.cache_dir = Path(config.cache_dir)
    if args.manifest is None and config.manifest_fp:
        args.manifest = Path(config.manifest_fp)
    if args.model_version is None and args.model_path is None:
        args.model_version = config.default_model_version

    model_version, model_fp = _resolve_tohr_model_spec(args)

    in_fps = args.in_fp if isinstance(args.in_fp, list) else [args.in_fp]

    shared = dict(
        max_depth=args.max_depth,
        dem_pct_clip=args.dem_pct_clip,
        window_method=args.window_method or config.window_method,
        tile_overlap=args.tile_overlap,
        tile_size=args.tile_size,
        input_kind=args.input_kind,
        output_compress=args.output_compress or config.output_compress,
        logger=log,
        engine_options={
            "compute_dtype": config.compute_dtype,
            "max_batch": config.max_batch,
            "output_transfer": config.output_transfer,
            "input_transfer": config.input_transfer,
            **_resolve_mesh_options(args),
        },
        device=args.device,
    )

    def resolve_dem(in_fp: Path) -> Path:
        if not args.fetch_hrdem:
            return args.dem
        from floodsr_tpu_torch.dem_sources import fetch_dem

        return fetch_dem(
            source_id="hrdem",
            depth_lr_fp=in_fp,
            output_fp=args.fetch_out,
            logger=log,
            target_res=args.fetch_res,
        ).dem_fp

    def resolve_buildings(in_fp: Path):
        if args.buildings is not None:
            return args.buildings
        if args.fetch_buildings:
            from floodsr_tpu_torch.features.nrcan_buildings import (
                fetch_buildings_for_raster,
            )

            return fetch_buildings_for_raster(
                raster_fp=in_fp, logger=log
            ).buildings_fp
        return None

    if len(in_fps) == 1:
        in_fp = in_fps[0]
        result = tohr(
            model_version=model_version,
            model_fp=model_fp,
            depth_lr_fp=in_fp,
            dem_hr_fp=resolve_dem(in_fp),
            output_fp=(
                args.out
                if args.out is not None
                else _resolve_default_output_path(in_fp)
            ),
            buildings_fp=resolve_buildings(in_fp),
            **shared,
        )
        print(result["output_fp"])
        return 0

    # Multi-scene serving: stream every input through one loaded model
    # (engine + device DEM cache reused; next scene's DEM prefetched while
    # the current one computes).
    if args.fetch_out is not None:
        raise ValueError(
            "--fetch-out names a single DEM file and cannot be combined with "
            "multiple --in rasters (each scene fetches its own DEM)"
        )
    if args.out is not None:
        out_dir = Path(args.out).expanduser()
        if out_dir.suffix:
            raise ValueError(
                "--out must name a directory when multiple --in rasters are given"
            )
        out_dir.mkdir(parents=True, exist_ok=True)

    def job_output(in_fp: Path) -> Path:
        default = _resolve_default_output_path(in_fp)
        return out_dir / default.name if args.out is not None else default

    jobs = [
        {
            "depth_lr_fp": in_fp,
            "dem_hr_fp": resolve_dem(in_fp),
            "output_fp": job_output(in_fp),
            "buildings_fp": resolve_buildings(in_fp),
        }
        for in_fp in in_fps
    ]
    # Two --in rasters with the same basename (different directories) would
    # silently write to the same --out file; refuse up front.
    seen: dict[Path, Path] = {}
    for job in jobs:
        out_fp = Path(job["output_fp"]).expanduser().resolve()
        if out_fp in seen:
            raise ValueError(
                f"output path collision: inputs '{seen[out_fp]}' and "
                f"'{job['depth_lr_fp']}' both resolve to '{out_fp}'; "
                "rename an input or use per-input output directories"
            )
        seen[out_fp] = Path(job["depth_lr_fp"])
    results = tohr_many(
        model_version=model_version, model_fp=model_fp, jobs=jobs, **shared
    )
    for result in results:
        print(result["output_fp"])
    return 0


def _cmd_doctor(args: argparse.Namespace) -> int:
    from floodsr_tpu_torch.engine import doctor_info

    for key, value in doctor_info().items():
        if isinstance(value, list):
            value = ",".join(str(v) for v in value)
        print(f"{key}={value}")
    return 0


def _cmd_cache_info(args: argparse.Namespace) -> int:
    info = cache_info(cache_dir=args.cache_dir)
    print(f"cache_dir={info['cache_dir']}")
    print(f"total_bytes={info['total_bytes']}")
    for name, stats in info["namespaces"].items():
        print(
            f"namespace.{name}=files:{stats['files']},bytes:{stats['bytes']},"
            f"age_days:{stats['age_days']}"
        )
    return 0


def _cmd_cache_purge(args: argparse.Namespace) -> int:
    result = cache_purge(
        cache_dir=args.cache_dir,
        older_than_days=args.older_than_days,
        namespace=args.namespace,
    )
    print(f"removed={','.join(result['removed']) or '-'}")
    print(f"freed_bytes={result['freed_bytes']}")
    return 0


def _cmd_serve(args: argparse.Namespace) -> int:
    from floodsr_tpu_torch.config import load_config
    from floodsr_tpu_torch.serve import serve

    config = load_config()

    # Validate the cheap inputs BEFORE model resolution: a typo'd --warmup
    # or --mesh must not abort only after a large weights download.
    warmup_shapes = []
    for spec in args.warmup or []:
        try:
            h, w = (int(part) for part in spec.lower().split("x"))
        except ValueError:
            raise ValueError(
                f"--warmup expects HxW (e.g. 3840x3840), got '{spec}'"
            ) from None
        warmup_shapes.append((h, w))
    mesh_options = _resolve_mesh_options(args)
    if args.max_pending < 1:
        raise ValueError(f"--max-pending must be >= 1, got {args.max_pending}")
    # Flag > env: tokens on command lines leak via process listings, so the
    # env form is the recommended one.
    auth_token = args.auth_token or os.environ.get("FLOODSR_SERVE_AUTH_TOKEN")

    if args.cache_dir is None and config.cache_dir:
        args.cache_dir = Path(config.cache_dir)
    if args.manifest is None and config.manifest_fp:
        args.manifest = Path(config.manifest_fp)
    if args.model_version is None and args.model_path is None:
        args.model_version = config.default_model_version
    model_version, model_fp = _resolve_tohr_model_spec(args)

    return serve(
        model_version=model_version,
        model_fp=model_fp,
        host=args.host,
        port=args.port,
        warmup_hr_shapes=warmup_shapes,
        engine_options={
            "compute_dtype": config.compute_dtype,
            "max_batch": config.max_batch,
            "output_transfer": config.output_transfer,
            "input_transfer": config.input_transfer,
            **mesh_options,
        },
        run_defaults={
            "window_method": config.window_method,
            "output_compress": config.output_compress,
        },
        max_pending=args.max_pending,
        auth_token=auth_token,
        data_root=args.data_root,
        logger_=log,
        device=args.device,
    )


_COMMAND_HANDLERS = {
    ("models", "list"): _cmd_models_list,
    ("models", "fetch"): _cmd_models_fetch,
    ("tohr", None): _cmd_tohr,
    ("serve", None): _cmd_serve,
    ("doctor", None): _cmd_doctor,
    ("cache", "info"): _cmd_cache_info,
    ("cache", "purge"): _cmd_cache_purge,
}


def main_cli(args: argparse.Namespace) -> int:
    """Dispatch a parsed command to its handler."""
    sub = getattr(args, "models_command", None) or getattr(args, "cache_command", None)
    handler = _COMMAND_HANDLERS.get((args.command, sub))
    if handler is None:
        raise ValueError(f"unsupported command path: {args.command}/{sub}")
    return handler(args)


def main(argv: list[str] | None = None) -> int:
    """Run the floodsr CLI and return an exit code."""
    from floodsr_tpu_torch import hostmem

    hostmem.tune_malloc()
    args = _parse_arguments(argv)
    _configure_logging(args)
    try:
        return main_cli(args)
    except Exception as err:
        log.error(f"{err}")
        log.debug("unhandled CLI exception", exc_info=True)
        return 1


def entry() -> None:  # pragma: no cover - console-script shim
    raise SystemExit(main())


# ---------------------------------------------------------------------------
# argument parsing
# ---------------------------------------------------------------------------


def _add_manifest_opt(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--manifest", type=Path, default=None,
        help="Alternate models.json manifest to resolve versions from.",
    )


def _add_fetch_opts(p: argparse.ArgumentParser) -> None:
    _add_manifest_opt(p)
    p.add_argument(
        "--cache-dir", type=Path, default=None,
        help="Weights cache directory (defaults to the platform user cache).",
    )
    p.add_argument(
        "--backend", choices=("http", "file"), default=None,
        help="Force a specific retrieval backend instead of URL-scheme dispatch.",
    )
    p.add_argument(
        "--force", action="store_true",
        help="Redownload even if a checksum-valid copy is already cached.",
    )


def _build_models_parser(subparsers) -> None:
    models = subparsers.add_parser("models", help="Inspect and fetch model weights.")
    verbs = models.add_subparsers(dest="models_command", required=True)
    _add_manifest_opt(verbs.add_parser("list", help="Print every manifest model version."))
    fetch = verbs.add_parser("fetch", help="Download one model version into the cache.")
    fetch.add_argument("version", help="Manifest version key to fetch.")
    _add_fetch_opts(fetch)


def _build_tohr_parser(subparsers) -> None:
    p = subparsers.add_parser("tohr", help="Super-resolve one depth raster.")
    p.add_argument(
        "--machine-json", type=Path, default=None,
        help="JSON file supplying tohr parameters (explicit flags win).",
    )
    p.add_argument(
        "--in", dest="in_fp", type=Path, required=True, nargs="+",
        help=(
            "Input low-resolution depth raster(s). With several inputs the "
            "scenes stream through one loaded model (next DEM prefetched "
            "while the current scene computes) and --out names a directory."
        ),
    )
    dem_source = p.add_mutually_exclusive_group(required=True)
    dem_source.add_argument(
        "--dem", type=Path, default=None, help="Input high-resolution DEM raster."
    )
    dem_source.add_argument(
        "-f", "--fetch-hrdem", action="store_true",
        help="Resolve the DEM automatically from the HRDEM STAC service.",
    )
    p.add_argument(
        "--fetch-out", type=Path, default=None,
        help="Where to keep a fetched DEM (default: session temp dir).",
    )
    p.add_argument(
        "--fetch-res", type=float, default=None, metavar="METERS",
        help=(
            "Coarsest acceptable fetched-DEM resolution (asset-CRS units). "
            "Coarser targets are served from the asset's COG overview "
            "levels, cutting remote bytes by roughly the squared "
            "decimation. Default: the asset's native resolution."
        ),
    )
    p.add_argument(
        "--out", type=Path, default=None,
        help="Output raster path (default: <input stem>_sr<ext> in the cwd).",
    )
    p.add_argument(
        "--model-version", default=None,
        help="Manifest version to run (fetched into the cache if needed).",
    )
    p.add_argument(
        "--model-path", type=Path, default=None,
        help="Run a local artifact file directly, bypassing the cache.",
    )
    _add_fetch_opts(p)
    p.add_argument(
        "--max-depth", type=float, default=None,
        help="Log-scaling depth ceiling in meters (default from train config).",
    )
    p.add_argument(
        "--dem-pct-clip", type=float, default=None,
        help="DEM percentile clip used when train stats are incomplete.",
    )
    p.add_argument(
        "--window-method", choices=("hard", "feather"), default=None,
        help="Tile blending: feathered overlap (default) or hard seams.",
    )
    p.add_argument(
        "--tile-overlap", type=int, default=None,
        help="Feather overlap in LR pixels (feather mode only).",
    )
    p.add_argument(
        "--tile-size", type=int, default=None,
        help=(
            "LR inference window size. Defaults to the model's trained LR "
            "tile. Native artifacts are fully convolutional: any "
            "multiple of 2^levels runs the same weights at a different "
            "window size (off the training distribution: re-validate "
            "quality before relying on it)."
        ),
    )
    p.add_argument(
        "--buildings", type=Path, default=None,
        help=(
            "GeoJSON building footprints to block: ResUNet zeroes "
            "super-resolved depths inside them; CostGrow excludes them from "
            "the connectivity domain (reference ADR-0016)."
        ),
    )
    p.add_argument(
        "--fetch-buildings", action="store_true",
        help=(
            "Resolve building footprints automatically from the NRCan "
            "automatically-extracted-buildings STAC collection for each "
            "input's footprint (like -f for the DEM)."
        ),
    )
    p.add_argument(
        "--output-compress", choices=("lzw", "zstd", "deflate", "packbits", "none"),
        default=None,
        help=(
            "Output GeoTIFF compression. Default: lzw (the reference's "
            "write profile); zstd or none trade file size for host "
            "encode time."
        ),
    )
    p.add_argument(
        "--input-kind", choices=("depth", "wse"), default=None,
        help=(
            "What the --in raster carries. Default: the model's native "
            "input (ResUNet_16x_DEM: depth; CostGrow: wse). 'wse' rasters "
            "are converted against the DEM (depth = max(WSE - DEM, 0) on "
            "the LR grid) before super-resolution."
        ),
    )
    _add_mesh_opts(p)
    _add_device_opt(p)


def _add_device_opt(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help=(
            "Where the model runs: the GPU (default; fails when CUDA is "
            "absent) or the CPU."
        ),
    )


def _add_mesh_opts(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help=(
            "Shard inference over a device mesh: 'auto' (all GPUs, data "
            "parallel), a device count, or axis sizes like 'dp=4,tp=2'. "
            "Default: single device."
        ),
    )
    p.add_argument(
        "--scene-mode", choices=("replicated", "banded"), default=None,
        help=(
            "Sharded-scene formulation (with --mesh): 'replicated' gathers "
            "tiles and updates a replicated scene (fastest for scenes that "
            "fit one device's memory); 'banded' row-shards the scene and its "
            "accumulators across dp (scenes beyond one device's memory)."
        ),
    )


def _resolve_mesh_options(args: argparse.Namespace) -> dict:
    """--mesh/--scene-mode -> engine_options entries (empty when unset)."""
    options: dict = {}
    if getattr(args, "mesh", None):
        from floodsr_tpu_torch.parallel.mesh import parse_mesh_spec

        options["mesh"] = parse_mesh_spec(args.mesh, device=args.device)
    if getattr(args, "scene_mode", None):
        if "mesh" not in options:
            raise ValueError("--scene-mode requires --mesh")
        options["scene_mode"] = args.scene_mode
    return options


def _build_serve_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "serve",
        help=(
            "Run a resident HTTP inference daemon: the model loads onto "
            "the device once, requests POST machine-interface JSON to "
            "/v1/tohr (rasters travel by filesystem path)."
        ),
    )
    p.add_argument(
        "--host", default="127.0.0.1",
        help="Bind address (default loopback; the daemon is unauthenticated).",
    )
    p.add_argument("--port", type=int, default=8571, help="Bind port.")
    p.add_argument(
        "--model-version", default=None,
        help="Manifest version to serve (fetched into the cache if needed).",
    )
    p.add_argument(
        "--model-path", type=Path, default=None,
        help="Serve a local artifact file directly, bypassing the cache.",
    )
    p.add_argument(
        "--warmup", action="append", default=None, metavar="HxW",
        help=(
            "Build the kernels and run one scene of zeros at an expected "
            "HR scene extent before accepting traffic (repeatable, e.g. "
            "--warmup 3840x3840)."
        ),
    )
    p.add_argument(
        "--max-pending", type=int, default=8,
        help=(
            "Requests admitted to the device queue before the daemon "
            "answers 503 (backpressure instead of unbounded queueing)."
        ),
    )
    p.add_argument(
        "--auth-token", default=None, metavar="TOKEN",
        help=(
            "Require 'Authorization: Bearer TOKEN' on every endpoint except "
            "/v1/healthz (constant-time compare). Prefer the "
            "FLOODSR_SERVE_AUTH_TOKEN environment variable: command lines "
            "leak via process listings."
        ),
    )
    p.add_argument(
        "--data-root", type=Path, default=None, metavar="DIR",
        help=(
            "Restrict every request-named filesystem path (inputs, DEM, "
            "outputs, buildings, fetch destinations) to this directory "
            "after symlink resolution; outside paths are rejected with 400."
        ),
    )
    _add_mesh_opts(p)
    _add_device_opt(p)
    _add_fetch_opts(p)


def _build_cache_parser(subparsers) -> None:
    cache = subparsers.add_parser("cache", help="Inspect or purge cached artifacts.")
    verbs = cache.add_subparsers(dest="cache_command", required=True)
    info = verbs.add_parser("info", help="Summarize cache usage per namespace.")
    info.add_argument("--cache-dir", type=Path, default=None)
    purge = verbs.add_parser("purge", help="Delete cached artifacts.")
    purge.add_argument("--cache-dir", type=Path, default=None)
    purge.add_argument(
        "--older-than-days", type=float, default=None,
        help="Purge only namespaces whose newest file exceeds this age.",
    )
    purge.add_argument("--namespace", default=None, help="Restrict purge to one namespace.")


def _parse_arguments(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="floodsr-torch",
        description="FloodSR command line interface (PyTorch/CUDA port).",
    )
    parser.add_argument(
        "-v", "--verbose", action="count", default=0,
        help="Louder logging; stack for more.",
    )
    parser.add_argument(
        "-q", "--quiet", action="count", default=0,
        help="Quieter logging; stack for less.",
    )
    parser.add_argument(
        "--log-level", choices=("DEBUG", "INFO", "WARNING", "ERROR"), default=None,
        help="Pin the log level, overriding -v/-q.",
    )
    subparsers = parser.add_subparsers(dest="command", required=True)
    _build_models_parser(subparsers)
    _build_tohr_parser(subparsers)
    _build_serve_parser(subparsers)
    subparsers.add_parser("doctor", help="Print runtime/device diagnostics as key=value.")
    _build_cache_parser(subparsers)
    return parser.parse_args(_inject_tohr_machine_json_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
