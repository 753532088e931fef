#!/bin/bash
# Full-scale runs of the port's experiment drivers on one card, the JAX
# package's recorded runs' arguments (results/*_tpu.*) where chip_smoke.py's
# [bench] phase cuts them: each driver through its own command line, one
# process each, its output in OUT (default bench_h100/; the committed copies
# are results/*_h100.*), its log in OUT/chip_bench.log. With the argument
# "scaling" it runs the weak-scaling driver over every card of the node; with
# "table4", the paper's Table 4 (the counterpart of the JAX package's
# tools/run_table4.sh, and of tools/scale_runs.sh's IVF4096,QINCo8 sweep) on
# one card, exiting nonzero when a mode fails or its gates do not hold; with
# "recorded", the JAX package's last recorded runs without an H100
# counterpart (search_100m's seven codecs at 10^8 over 65,536 lists and four
# over 262,144, P1 with IVF1024,PQ16 and with IVF128,Flat at 10^6, the flat
# quantizer over 2^20 centroids, codec_scale at 3 x 10^7, the small P1, P2
# and P5 runs) on one card, then the ROC kernels at their lane shapes and
# bench/recorded.py's gates, exiting nonzero when a run fails or a gate does
# not hold.
#
#   OUT=DIR bash chip_bench.sh
#   OUT=DIR bash chip_bench.sh scaling
#   OUT=DIR bash chip_bench.sh table4
#   OUT=DIR bash chip_bench.sh recorded
set -u
OUT=${OUT:-bench_h100}
mkdir -p "$OUT"
M=vector_db_id_compression_tpu_torch.bench
LOG=$OUT/chip_bench.log

run() {  # run NAME COMMAND...: the command's stdout and stderr to the log
    local name=$1 start=$SECONDS
    shift
    echo "=== $name: $*" | tee -a "$LOG"
    "$@" >> "$LOG.$name" 2>&1
    local rc=$?
    tail -n 3 "$LOG.$name" >> "$LOG"
    echo "=== $name: exit $rc in $((SECONDS - start)) s" | tee -a "$LOG"
    return $rc
}

{ free -g; nvidia-smi --query-gpu=name,power.limit --format=csv,noheader; } | tee -a "$LOG"

if [ "${1:-}" = "table4" ]; then
    # IVF65536,QINCo16x8 over 10^7 synthetic vectors of d 32 (reference
    # README.md:161-197): train and add once, then one search per id codec
    # at nprobe 128, shortlist 200, k 100, 5 runs after a warm-up, each a
    # process of its own resuming from the saved index, as the JAX script
    # runs them; each step under its own time limit
    failed=""
    wd=$OUT/qinco10m65k
    common=(--dataset synthetic --synth_scale 100 --workdir "$wd" --nlist 65536 --M 16
            --ksub 256 --hidden 256 --kmeans_niter 20 --qinco_steps 300 --seed 0)
    run table4_train_add timeout 1200 python -m $M.search_ivf_qinco --todo train add \
        "${common[@]}" || exit 1
    outs=()
    for mode in none packed-bits elias-fano roc wavelet-tree wavelet-tree-1; do
        out=$OUT/search_ivf_qinco_synthetic10m_65k_${mode}_h100.json
        outs+=("$out")
        run table4_$mode timeout 900 python -m $M.search_ivf_qinco --todo search \
            "${common[@]}" --id_compression "$mode" --defer_id_decoding --nprobe 128 \
            --nshort 200 --k 100 --runs 5 && cp "$wd/search_results.json" "$out" \
            || failed="$failed $mode"
    done
    run table4_check python -m $M.table4 check "${outs[@]}" || failed="$failed check"
    # where the time goes: add's stages, one roc and one wavelet-tree-1
    # search under torch.profiler
    run table4_profile timeout 900 python -m $M.table4 profile --workdir "$wd" \
        --out "$OUT/table4_profile_h100.json" || failed="$failed profile"
    rm -rf "$wd"
    # the IVF4096,QINCo8 operating points of tools/scale_runs.sh, raw and ROC
    # ids, recalls gated equal
    wd=$OUT/qinco10m
    common=(--dataset synthetic --synth_scale 100 --workdir "$wd" --nlist 4096 --M 8
            --ksub 256 --hidden 256 --qinco_steps 300 --seed 0)
    run sweep_train_add timeout 1200 python -m $M.search_ivf_qinco --todo train add \
        "${common[@]}" || exit 1
    for mode in roc none; do
        run sweep_$mode timeout 900 python -m $M.search_ivf_qinco --todo search "${common[@]}" \
            --id_compression $mode --defer_id_decoding --nprobe 16 64 128 --nshort 50 100 200 \
            --k 100 --runs 2 \
            && cp "$wd/search_results.json" "$OUT/search_ivf_qinco_synthetic10m_${mode}_sweep_h100.json" \
            || failed="$failed sweep_$mode"
    done
    run sweep_check python -m $M.table4 check "$OUT"/search_ivf_qinco_synthetic10m_{roc,none}_sweep_h100.json \
        || failed="$failed sweep_check"
    rm -rf "$wd"
    cat "$LOG.table4_check" "$LOG.sweep_check"
    [ -z "$failed" ] || { echo "FAILED:$failed" | tee -a "$LOG"; exit 1; }
    exit 0
fi

if [ "${1:-}" = "recorded" ]; then
    # each run a process of its own under its own time limit (PERF.md's
    # predictions, about twice each), in the order of the JAX package's
    # records; a run that fails is named at the end, the rest go on
    failed=""
    r=results
    run search_100m timeout 3000 python -m $M.search_100m --ntotal 100000000 --nlist 65536 \
        --methods none packed-bits elias-fano roc roc-interleaved wavelet-tree wavelet-tree-1 \
        --out "$OUT/search_100m_h100.json" || failed="$failed search_100m"
    run search_100m_262k timeout 1500 python -m $M.search_100m --ntotal 100000000 \
        --nlist 262144 --methods none roc elias-fano packed-bits \
        --out "$OUT/search_100m_262k_h100.json" || failed="$failed search_100m_262k"
    run p1_pq16 timeout 1200 python -m $M.bench_invlists --dataset synthetic --synth_scale 10 \
        --index IVF1024,PQ16 --nprobe 1 4 16 --runs 20 --fused \
        --out "$OUT/bench_invlists_synthetic1m_pq16_h100.csv" || failed="$failed p1_pq16"
    run p1_longlist timeout 900 python -m $M.bench_invlists --dataset synthetic \
        --synth_scale 10 --index IVF128,Flat --nprobe 1 4 --runs 5 \
        --methods ref roc roc-interleaved \
        --out "$OUT/bench_invlists_synthetic1m_longlist_h100.csv" || failed="$failed p1_longlist"
    # the ROC kernels over the long lists (their layout, against the plain
    # versions), over search_100m's 262,144 lists and its 65,536 lists'
    # interleaved lanes
    run lanes_ivf128 timeout 900 python -m $M.recorded lanes --index IVF128,Flat \
        --synth_scale 10 --plain --csv "$OUT/bench_invlists_synthetic1m_longlist_h100.csv" \
        --out "$OUT/lanes_ivf128_h100.json" || failed="$failed lanes_ivf128"
    for nlist in 65536 262144; do
        run lanes_100m_$nlist timeout 900 python -m $M.recorded lanes --ntotal 100000000 \
            --nlist $nlist --out "$OUT/lanes_100m_${nlist}_h100.json" \
            || failed="$failed lanes_100m_$nlist"
    done
    run quantizer_1m timeout 600 python -m $M.quantizer_bench --nlist 1048576 --nprobe 128 \
        --skip-hnsw --out "$OUT/quantizer_1m_flat_h100.json" \
        --dump-probes "$OUT/quantizer_1m_flat_probes.npy" || failed="$failed quantizer_1m"
    run codec_scale_30m timeout 600 python -m $M.codec_scale --ntotal 30000000 --nlist 65536 \
        || failed="$failed codec_scale_30m"
    { echo "=== python -m $M.codec_scale --ntotal 30000000 --nlist 65536 ==="
      grep -h '^{' "$LOG.codec_scale_30m"; } > "$OUT/codec_scale_30m_h100.jsonl"
    run p1_small timeout 600 python -m $M.bench_invlists --dataset synthetic --synth_scale 0.3 \
        --index IVF128,Flat --nprobe 1 4 16 --runs 2 \
        --out "$OUT/bench_invlists_synthetic_h100.csv" || failed="$failed p1_small"
    run p2_small timeout 600 python -m $M.graph_dynamic_bench --dataset synthetic \
        --synth_scale 0.05 --max-degree 16 --k 10 --runs 10 \
        --out "$OUT/graph_dynamic_bench_synthetic_h100.csv" || failed="$failed p2_small"
    wd=$OUT/qinco_small
    run p5_small timeout 900 python -m $M.search_ivf_qinco --todo train add search \
        --dataset synthetic --synth_scale 0.3 --workdir "$wd" --nlist 128 --M 8 --hidden 128 \
        --qinco_steps 400 --id_compression roc --defer_id_decoding --nprobe 16 --nshort 100 \
        --k 100 --runs 3 && cp "$wd/search_results.json" "$OUT/search_ivf_qinco_synthetic_h100.json" \
        || failed="$failed p5_small"
    rm -rf "$wd"
    run recorded_check python -m $M.recorded check \
        --search-100m "$OUT/search_100m_h100.json" $r/search_100m_tpu.json \
        --search-100m "$OUT/search_100m_262k_h100.json" $r/search_100m_262k_tpu.json \
        --p1 "$OUT/bench_invlists_synthetic1m_pq16_h100.csv" \
        --p1 "$OUT/bench_invlists_synthetic1m_longlist_h100.csv" \
        --p1 "$OUT/bench_invlists_synthetic_h100.csv" \
        --codec-scale "$OUT/codec_scale_30m_h100.jsonl" $r/codec_scale_tpu.jsonl \
        --quantizer "$OUT/quantizer_1m_flat_h100.json" "$OUT/quantizer_1m_flat_probes.npy" \
        || failed="$failed check"
    cat "$LOG.recorded_check"
    [ -z "$failed" ] || { echo "FAILED:$failed" | tee -a "$LOG"; exit 1; }
    exit 0
fi

if [ "${1:-}" = "scaling" ]; then
    # weak scaling over the node's cards, one NCCL rank each, at about 10^6
    # ids a rank (chip_smoke.py's index: 1024 lists of about 1000 ids; the
    # search at d 128, 1000 queries, nprobe 16)
    n=$(nvidia-smi -L | wc -l)
    size=(--devices 1 2 4 --lists-per-device 1024 --ids-per-list 1000)
    run scaling torchrun --nproc_per_node "$n" -m $M.scaling "${size[@]}"
    run scaling_search torchrun --nproc_per_node "$n" -m $M.scaling "${size[@]}" \
        --search --phases --search-d 128 --search-nq 1000 --search-nprobe 16
    grep -h '^{' "$LOG.scaling" > "$OUT/scaling_h100x$n.json"
    grep -h '^{' "$LOG.scaling_search" > "$OUT/scaling_search_h100x$n.json"
    exit 0
fi

run bench_invlists python -m $M.bench_invlists --dataset synthetic --synth_scale 10 \
    --index IVF1024,Flat --nprobe 1 4 16 --runs 5 --out "$OUT/bench_invlists_synthetic1m_h100.csv"
for n in 10000000 100000000; do
    run codec_scale_$n python -m $M.codec_scale --ntotal $n --nlist 65536
    { echo "=== python -m $M.codec_scale --ntotal $n --nlist 65536 ==="
      grep -h '^{' "$LOG.codec_scale_$n"; } >> "$OUT/codec_scale_h100.jsonl"
done
run graph_dynamic python -m $M.graph_dynamic_bench --synth_scale 10 --max-degree 32 --runs 5 \
    --out "$OUT/graph_dynamic_bench_synthetic1m_h100.csv"
run graph_static python -m $M.graph_static_bench --synth_scale 0.04 --max-degree 16 \
    --out "$OUT/graph_static_bench_synthetic_h100.csv"
run hnsw_bench python -m $M.hnsw_bench --synth_scale 0.04 --M 16 \
    --out "$OUT/hnsw_bench_synthetic_h100.csv"
run qinco python -m $M.search_ivf_qinco --todo train add search --synth_scale 1 --nlist 256 \
    --M 8 --hidden 128 --qinco_steps 300 --id_compression roc --defer_id_decoding --nprobe 32 \
    --nshort 100 --k 100 --workdir "$OUT/qinco_work"
cp "$OUT/qinco_work/search_results.json" "$OUT/search_ivf_qinco_synthetic100k_h100.json"
rm -rf "$OUT/qinco_work"
run wt0 python -m $M.wt_translate_bench --ntotal 10000000 --nlist 65536 --wt-type 0 \
    --out "$OUT/wt_translate_10m65k_h100.json"
run wt1 python -m $M.wt_translate_bench --ntotal 10000000 --nlist 65536 --wt-type 1 \
    --out "$OUT/wt_translate_10m65k_wt1_h100.json"
run search_100m python -m $M.search_100m --ntotal 100000000 --nlist 65536 \
    --out "$OUT/search_100m_h100.json"
run quantizer timeout 1500 python -m $M.quantizer_bench --nlist 262144 \
    --out "$OUT/quantizer_262k_h100.json"
