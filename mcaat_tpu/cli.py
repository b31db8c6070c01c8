"""CLI entry point.

Same flag surface as the reference (``src/main.cpp:89-301``): settings
file provides defaults, CLI overrides; timestamped default output folder;
output/graph/cycles directories created up front; defaults threads =
cores - 2 and ram = 95% of system RAM.

Run as ``python -m mcaat_tpu --input-files reads.fq [mate2.fq] [options]``.
"""

from __future__ import annotations

import os
import sys

from mcaat_tpu.settings import (
    Settings,
    get_total_system_ram_gb,
    parse_ram_to_gb,
)

USAGE = """Usage: python -m mcaat_tpu --input-files <file1> [file2] [options]

Required:
  --input-files <file1> [file2]   One or two input FASTA/FASTQ files

Optional:
  --ram <amount>                  RAM to use (e.g., 4G, 500M). Default: 95% of system RAM
  --threads <num>                 Number of threads. Default: CPU cores - 2
  --output-folder <path>          Output directory. If not provided, a timestamped folder is created
  --benchmark <file>              File containing expected crispr sequences line separated
  --cycle-max-length <int>        Maximum cycle length to search (default in settings)
  --cycle-min-length <int>        Minimum cycle length to search (default in settings)
  --threshold-multiplicity <int>  Minimum multiplicity threshold for start nodes (default in settings)
  --low-abundance <true|false>    Enable low abundance mode for cycle filtering
  --settings <path>               Path to a key=value settings file (overridden by CLI args)
  --mesh <auto|off>               Shard the graph over all visible devices (default: auto);
                                  'off' runs on the first device only
  --help, -h                      Show this help message
"""


def parse_arguments(argv: list[str]) -> Settings:
    settings = Settings()
    timestamp = settings.get_timestamp()

    # Pre-scan for --settings so file values act as defaults (main.cpp:96-104)
    for j, arg in enumerate(argv):
        if arg == "--settings" and j + 1 < len(argv):
            if not settings.load_from_file(argv[j + 1]):
                raise RuntimeError(
                    f"Error: could not load settings from {argv[j + 1]}"
                )
            break

    input_files: list[str] = []
    output_folder_provided = False
    required_files_provided = False
    input_files_from_settings = False
    cfs = settings.cycle_finder_settings

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("--help", "-h", ""):
            print(USAGE)
            sys.exit(0)
        elif arg in ("--input-files", "-i"):
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                input_files.append(argv[i])
            required_files_provided = True
        elif arg == "--benchmark":
            i += 1
            if i >= len(argv):
                raise RuntimeError("Error: Missing value for --benchmark")
            settings.benchmark_file = argv[i]
        elif arg == "--ram":
            i += 1
            if i >= len(argv):
                raise RuntimeError("Error: Missing value for --ram")
            settings.ram = parse_ram_to_gb(argv[i])
            settings.ram_explicit = True
            total = get_total_system_ram_gb()
            if settings.ram < 1.0:
                raise RuntimeError(
                    f"Error: RAM value {settings.ram} GB is too low "
                    "(must be at least 1 GB)"
                )
            if total and settings.ram > total:
                raise RuntimeError(
                    f"Error: RAM value {settings.ram} GB exceeds system total "
                    f"of {total} GB"
                )
        elif arg == "--threads":
            i += 1
            if i >= len(argv):
                raise RuntimeError("Error: Missing value for --threads")
            settings.threads = int(argv[i])
        elif arg in ("--output-folder", "--output_folder"):
            i += 1
            if i >= len(argv):
                raise RuntimeError("Error: Missing value for --output-folder")
            settings.output_folder = argv[i]
            output_folder_provided = True
        elif arg == "--cycle-max-length":
            i += 1
            cfs.cycle_max_length = int(argv[i])
        elif arg == "--cycle-min-length":
            i += 1
            cfs.cycle_min_length = int(argv[i])
        elif arg == "--threshold-multiplicity":
            i += 1
            cfs.threshold_multiplicity = int(argv[i])
        elif arg == "--low-abundance":
            i += 1
            cfs.low_abundance = argv[i].lower() in ("1", "true", "yes")
        elif arg == "--settings":
            i += 1  # handled in the pre-scan
        elif arg == "--debug-pipeline":
            settings.debug_pipeline = True
        elif arg == "--resume":
            settings.resume = True
        elif arg == "--mesh":
            i += 1
            if i >= len(argv):
                raise RuntimeError("Error: Missing value for --mesh")
            if argv[i] not in ("auto", "off"):
                raise RuntimeError("Error: --mesh must be 'auto' or 'off'")
            settings.mesh = argv[i]
        i += 1

    if not input_files and settings.input_files:
        input_files = settings.input_files.split()
        required_files_provided = True
        input_files_from_settings = True

    if not required_files_provided and not input_files:
        raise RuntimeError(
            "Error: No input files provided. Use --input-files <file1> [file2]"
        )
    if not output_folder_provided and not settings.output_folder:
        settings.output_folder = f"mcaat_run_{timestamp}"
    if not settings.graph_folder:
        settings.graph_folder = settings.output_folder + "/graph"
    if not settings.cycles_folder:
        settings.cycles_folder = settings.output_folder + "/cycles"
    if not settings.output_file:
        settings.output_file = settings.output_folder + "/CRISPR_Arrays.txt"

    os.makedirs(settings.output_folder, exist_ok=True)
    os.makedirs(settings.graph_folder, exist_ok=True)
    os.makedirs(settings.cycles_folder, exist_ok=True)

    if len(input_files) < 1 or len(input_files) > 2:
        raise RuntimeError("Error: You must provide one or two input files.")
    for f in input_files:
        if not os.path.exists(f):
            raise RuntimeError(f"Error: Input file {f} does not exist.")
    if required_files_provided and not input_files_from_settings:
        settings.input_files = " ".join(input_files)

    if settings.threads == 0:
        settings.threads = max((os.cpu_count() or 3) - 2, 1)
    if settings.ram == 0.0:
        settings.ram = get_total_system_ram_gb() * 0.95
    return settings


def main(argv: list[str] | None = None) -> int:
    # multi-host entry: wires jax.distributed from MCAAT_COORDINATOR /
    # MCAAT_NUM_PROCESSES / MCAAT_PROCESS_ID before any backend init
    # (no-op for single-process runs; see parallel/multihost.py)
    from mcaat_tpu.parallel.multihost import initialize_distributed

    multihost = initialize_distributed()

    from mcaat_tpu.pipeline import run_pipeline

    print("-------------------------------------------------------")
    print("mcaat_tpu - Metagenomic CRISPR Array Analysis")
    print("-------------------------------------------------------")
    settings = parse_arguments(argv if argv is not None else sys.argv[1:])
    print("Step 1. Checking the inputs: ")
    err = settings.print_settings()
    if err:
        # ≙ release main's interactive cleanup of the just-created output
        # folder on bad settings (src/main.cpp:503-512). Non-interactive
        # stdin (tests, batch jobs) behaves like answering 'n'.
        print(f"Please check the following: {err}")
        print(f"Folder {settings.output_folder} will be deleted due to errors.")
        answer = ""
        if sys.stdin is not None and sys.stdin.isatty():
            answer = input("Do you want that folder to be removed? (y/n): ")
        if not answer or answer[0] not in "yY":
            print("Exiting the program.")
            return 1
        print(f"Removing folder: {settings.output_folder}")
        import shutil

        shutil.rmtree(settings.output_folder, ignore_errors=True)
        return 1
    print("All inputs are correct. [✔]")
    if multihost:
        from mcaat_tpu.parallel.multihost import run_pipeline_multihost

        run_pipeline_multihost(settings)
    elif settings.debug_pipeline:
        from mcaat_tpu.pipeline import run_debug_pipeline

        run_debug_pipeline(settings)
    else:
        run_pipeline(
            settings,
            checkpoint_dir=settings.graph_folder if settings.resume else None,
        )
        # ≙ end-of-run graph-folder cleanup (src/main.cpp:584-590); kept
        # only when the folder holds resume checkpoints the user asked for
        if settings.graph_folder and not settings.resume:
            import shutil

            try:
                shutil.rmtree(settings.graph_folder)
            except OSError as e:
                print(f"Warning: Could not remove graph folder: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
