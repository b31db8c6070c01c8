// Reference-parity driver: runs the REFERENCE's own pipeline sources
// (compiled unmodified from /root/reference/src) over a graph built by
// mcaat_tpu, so the two implementations' outputs can be compared end to end.
//
// Mirrors the release main() flow from the graph-load point on
// (src/main.cpp:517-591): load SDBG (mock, backed by the mcaat_tpu graph
// dump) -> CycleFinder -> cycles_map_to_cycles -> get_reads ->
// run_and_debug_spacer_ordering -> CRISPRAnalyzer -> CRISPR_Arrays.txt.
// The SDBGBuild stage is the one part that cannot run (the megahit
// submodule is empty in this snapshot), which is exactly why the graph
// comes from the JAX build.
//
// Usage: ref_driver <graph.dump> <out_report.txt> <fastq1> [fastq2]
//                   [--filters] [--benchmark <truth_file>]
//
//   --filters    run the DEBUG-main Filters path instead of the release
//                ordering path (src/main.cpp:446-458: Filters::ListArrays
//                -> CRISPRAnalyzer), compiled from src/filters.cpp.
//   --benchmark  run STEP 8 in benchmark mode against the given
//                ground-truth file (src/main_run_and_debug.cpp:142-212).

#include <cstring>
#include <iostream>
#include <string>

#include "cycle_finder.h"
#include "filters.h"
#include "main_run_and_debug.h"
#include "post_processing.h"
#include "sdbg/sdbg.h"
#include "settings.h"
#include "tmp_utils.h"

int main(int argc, char **argv) {
  bool filters_mode = false;
  std::string benchmark_file;
  std::vector<std::string> pos;
  for (int i = 1; i < argc; ++i) {
    if (std::strcmp(argv[i], "--filters") == 0) {
      filters_mode = true;
    } else if (std::strcmp(argv[i], "--benchmark") == 0 && i + 1 < argc) {
      benchmark_file = argv[++i];
    } else {
      pos.push_back(argv[i]);
    }
  }
  if (pos.size() < 3) {
    std::cerr << "usage: ref_driver <graph.dump> <out_report.txt> <fastq1> "
                 "[fastq2] [--filters] [--benchmark <truth>]"
              << std::endl;
    return 2;
  }
  Settings settings;
  settings.threads = 1;  // deterministic schedule for parity comparison
  settings.input_files = pos[2];
  if (pos.size() > 3) settings.input_files += " " + pos[3];
  settings.output_file = pos[1];
  settings.benchmark_file = benchmark_file;

  SDBG sdbg;
  if (!sdbg.LoadFromFile(pos[0].c_str())) {
    std::cerr << "failed to load graph dump: " << pos[0] << std::endl;
    return 1;
  }
  std::cout << "Loaded the graph (" << sdbg.size() << " nodes, k=" << sdbg.k()
            << ")" << std::endl;
  settings.sdbg = &sdbg;

  std::cout << "FBCE START:" << std::endl;
  CycleFinder cycle_finder(settings);
  auto cycles_map = cycle_finder.results;
  std::cout << "Number of nodes in results: " << cycles_map.size() << std::endl;

  if (filters_mode) {
    // DEBUG-main path (src/main.cpp:446-458)
    std::cout << "FILTERS START:" << std::endl;
    int number_of_spacers = 0;
    Filters filters(sdbg, cycle_finder.results);
    auto SYSTEMS = filters.ListArrays(number_of_spacers);
    std::cout << "Number of spacers: " << number_of_spacers
              << " before cleaning" << std::endl;
    std::cout << "POST PROCESSING START:" << std::endl;
    CRISPRAnalyzer analyzer(SYSTEMS, settings.output_file);
    analyzer.run_analysis();
    std::cout << "Saved in: " << settings.output_file << std::endl;
    return 0;
  }

  auto cycles = cycles_map_to_cycles(cycles_map);

  std::cout << "STEP 6: Finding relevant reads" << std::endl;
  const auto reads =
      run_and_debug_finding_of_relevant_reads(cycles, settings, sdbg);

  std::cout << "STEP 7: Order the spacers" << std::endl;
  const auto found_systems = run_and_debug_spacer_ordering(reads, sdbg, cycles);

  if (!benchmark_file.empty()) {
    std::cout << "STEP 8: Benchmark" << std::endl;
    run_and_debug_benchmark_results(settings, found_systems);
  } else {
    std::cout << "STEP 8: Results" << std::endl;
    run_and_debug_results(found_systems);
  }

  std::cout << "POST PROCESSING START:" << std::endl;
  std::unordered_map<std::string, std::vector<std::string>> all_systems;
  for (const auto &[_sequence, repeat, spacers, _conf_a, _conf_b] :
       found_systems) {
    all_systems[repeat] = spacers;
  }
  CRISPRAnalyzer analyzer(all_systems, settings.output_file);
  analyzer.run_analysis();
  std::cout << "Saved in: " << settings.output_file << std::endl;
  return 0;
}
